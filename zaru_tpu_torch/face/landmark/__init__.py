"""Face landmark models (zaru_tpu/face/landmark)."""
