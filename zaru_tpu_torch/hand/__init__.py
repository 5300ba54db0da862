"""Hand perception: palm detection and 21-point hand landmarks
(zaru_tpu/hand)."""
