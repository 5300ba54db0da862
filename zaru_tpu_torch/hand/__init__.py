"""Hand perception: palm detection, 21-point hand landmarks and the host
multi-hand tracker (zaru_tpu/hand)."""
