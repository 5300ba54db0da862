"""Face models (zaru_tpu/face)."""
