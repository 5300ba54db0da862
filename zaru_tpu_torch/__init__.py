"""zaru_tpu_torch: the PyTorch/CUDA port of zaru_tpu for NVIDIA Hopper.

A second package beside ``zaru_tpu``, which stays the reference: this one
imports ``torch`` and numpy, never ``jax`` and nothing of ``zaru_tpu``. Its
module names mirror the JAX package's, and each module's docstring names
its counterpart there. Entry points run on ``cuda`` unless the caller
passes another ``device`` (the tests pass ``device="cpu"``); without a GPU
they raise rather than fall back to the CPU.

Ported so far: ``FaceTracker`` with every entry point of the JAX one
(the batch-gated ``step_batch``/``run_frames_gated``, the ungated
``run_frames``, the single-stream ``step``/``run_frame`` and
``scan_video``), iris, bounded redetection, the exact sampler
(``fast_sampler=False``) and both face detectors and landmarkers
(``face.detection.ShortRangeNetwork``/``FullRangeNetwork``,
``face.landmark.mediapipe.FaceMeshV1``/``FaceMeshV2``);
``MultiFaceTracker``, ``MultiHandTracker`` and ``BodyTracker`` with the same
entry points; hand-written CUDA kernels for every TPU kernel of the JAX
package (``zaru_tpu_torch/csrc``); the serving entry points: the multi-stream
serve loop (:mod:`zaru_tpu_torch.serve`), the double-buffered frame upload
(:mod:`zaru_tpu_torch.pipeline.ingest`) and ``python -m zaru_tpu_torch
track|serve|info``; the host engines (``nn.NeuralNetwork``/``Loader``,
``detection.Detector``, ``landmark.Estimator``/``LandmarkTracker``,
``hand.tracking.HandTracker``) with every network's host decode and the
68-point landmarkers (``face.landmark.multipie68``); the equivariance sweep
(:mod:`zaru_tpu_torch.eval`, ``python -m zaru_tpu_torch eval``);
``compute_dtype=torch.bfloat16`` (bf16 network bodies) on every network
and on ``FaceTracker``, ``MultiHandTracker`` and ``BodyTracker``; face
identification (``face.recognition.Embedder``, ``face.identify``'s
``FaceIdentifier`` and ``StreamIdentifier``), ``image.blend``, ``quat``,
``procrustes``, ``pnp`` and ``approx``; the JAX importer's whole ONNX
dialect and the NHWC layout; ``export`` (a tracker step as a
``torch.export`` program, the kernels as registered ops, and ``python -m
zaru_tpu_torch export|run-exported``), ``train.Trainer``, ``checkpoint``,
``profiling`` and ``onnx.analysis``; stream sharding over several devices
(``parallel.ShardedTracker``, ``stream_mesh``, ``serve --shard``) and
data-parallel training (``train.make_data_parallel_train_step``) in one
process; the native JPEG bridge (``native``, the ``native`` decode backend)
and the camera sources (``video.HttpCam``, ``video.Webcam``). Not ported:
the GUI (ROADMAP Queue 1).
"""

__version__ = "0.1.0"

from ._device import resolve_device
from .pipeline import BodyTracker, FaceTracker, MultiFaceTracker, MultiHandTracker

__all__ = ["BodyTracker", "FaceTracker", "MultiFaceTracker", "MultiHandTracker", "resolve_device"]
