"""The demo examples on the port (examples/*.py of the JAX package), run as
``python -m zaru_tpu_torch.examples.<name> [args] [--device D]``.

Each shows its frames through :mod:`zaru_tpu_torch.gui` (``ZARU_TPU_GUI``:
``cv2``, ``file`` or ``none``) and runs on ``--device`` (``cuda`` unless
named; without a GPU it raises rather than use the CPU). Without an image
argument a frame source tries the webcam, then loops the bundled photo
(``ZARU_TPU_EXAMPLE_FRAMES`` times, 30 by default).
"""
