"""Debug GUI: per-key image windows and the app harness (zaru_tpu/gui).

:func:`run` keeps the *main* thread as the window/event-loop owner and runs
the app callback on a spawned thread; :func:`show_image` posts frames to
the loop, which opens one window per key, shows a live FPS readout in the
title and maps window-close / ESC to app shutdown. Without :func:`run`
(plain library use), ``show_image`` renders directly.

``show_image`` takes a port :class:`~zaru_tpu_torch.image.Image`, a
``torch.Tensor`` on any device or a numpy array, all ``[H, W, 3|4]
uint8``. A device frame is read to the host once, on the
caller's thread, before it is posted: the event loop never touches CUDA.

Back-ends, chosen by ``ZARU_TPU_GUI``:

- ``cv2``  — OpenCV HighGUI windows (the default when ``$DISPLAY`` is set)
- ``file`` — frames written as PNGs under ``ZARU_TPU_GUI_DIR`` (default
  ``zaru_tpu_gui`` in the temporary directory); the headless default
- ``none`` — drop frames

``ZARU_TPU_LOG`` sets the log level (:func:`init_logger`).
"""

from __future__ import annotations

import logging
import os
import sys
import threading

import numpy as np
import torch

from .loop import EventLoop, make_renderer

log = logging.getLogger(__name__)

__all__ = ["show_image", "request_stop", "run", "main", "init_logger"]

_active_loop: EventLoop | None = None
_fallback_renderers: dict[tuple, object] = {}
_fallback_dismissed: set[tuple] = set()


def _backend() -> str:
    env = os.environ.get("ZARU_TPU_GUI")
    if env:
        return env
    return "cv2" if os.environ.get("DISPLAY") else "file"


def _host_frame(image) -> np.ndarray:
    """``image`` as a host ``[H, W, C] uint8`` array (one device read)."""
    if hasattr(image, "to_numpy"):
        return image.to_numpy()
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def show_image(key: str, image) -> None:
    """Displays ``image`` in the window named ``key``. Inside :func:`run`,
    posts to the event loop; standalone, renders directly. Once the user
    dismisses the standalone window (close button / ESC), further frames
    are dropped: the window must not keep reopening, and a library call
    cannot end the host script."""
    arr = _host_frame(image)
    loop = _active_loop
    if loop is not None:
        loop.post(key, arr)
        return
    backend = _backend()
    if backend == "cv2" and threading.current_thread() is not threading.main_thread():
        # After the event loop exits (window closed / ESC), an app thread
        # still running must not touch HighGUI (main thread only); drop
        # the frame: the process is shutting down.
        return
    cache_key = (backend, os.environ.get("ZARU_TPU_GUI_DIR"))
    if cache_key in _fallback_dismissed:
        return
    renderer = _fallback_renderers.get(cache_key)
    if renderer is None:
        renderer = _fallback_renderers[cache_key] = make_renderer(backend)
    renderer.render(key, arr)
    if backend == "cv2" and not renderer.poll():
        _fallback_dismissed.add(cache_key)
        renderer.close()
        _fallback_renderers.pop(cache_key, None)


def request_stop(code: int = 0) -> None:
    """Asks the running event loop to shut the app down (what closing the
    window does)."""
    loop = _active_loop
    if loop is not None:
        loop.request_stop(code)


def init_logger(level=logging.DEBUG) -> None:
    """Default logging: ``level`` (debug) for the app (``__main__``) and
    ``zaru_tpu_torch``, warnings elsewhere; ``ZARU_TPU_LOG`` overrides the
    level (``debug`` or ``DEBUG``, or a number)."""
    env_level = os.environ.get("ZARU_TPU_LOG")
    if env_level:
        level = int(env_level) if env_level.isdigit() else env_level.upper()
    logging.basicConfig(
        level=logging.WARNING,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    logging.getLogger("zaru_tpu_torch").setLevel(level)
    logging.getLogger("__main__").setLevel(level)


def run(callback) -> None:
    """Runs an app callback under the GUI event loop, with logging and
    exit codes: an exception exits 1, ``KeyboardInterrupt`` 130,
    ``SystemExit`` its code, a non-zero int returned that int.

    The callback runs on a worker thread; this (main) thread runs the
    window event loop until the callback has finished (and every frame is
    rendered) or the user closes a window / presses ESC.
    """
    global _active_loop
    init_logger()
    loop = EventLoop(make_renderer(_backend()))
    _active_loop = loop
    outcome: dict = {}

    def worker():
        try:
            outcome["result"] = callback()
        except KeyboardInterrupt:
            outcome["code"] = 130
        except SystemExit as e:
            outcome["code"] = e.code if isinstance(e.code, int) else 0
        except Exception:
            log.exception("app callback failed")
            outcome["code"] = 1
        finally:
            loop.notify_user_done()

    thread = threading.Thread(target=worker, name="zaru-app", daemon=True)
    thread.start()
    try:
        loop.run()
    except KeyboardInterrupt:
        _active_loop = None
        sys.exit(130)
    _active_loop = None

    if loop.ui_requested_exit:
        # Window closed / ESC: end the app; the app thread is a daemon and
        # dies with the process.
        sys.exit(loop.exit_code or 0)
    thread.join(timeout=5)
    if "code" in outcome:
        sys.exit(outcome["code"])
    result = outcome.get("result")
    if isinstance(result, int) and result != 0:
        sys.exit(result)


def main(fn):
    """Decorator: calling the decorated function runs it under the GUI
    event loop. It runs on call, not at decoration (helpers defined below
    it must exist first)::

        @gui.main
        def main(): ...

        if __name__ == "__main__":
            main()
    """

    def wrapper():
        run(fn)

    wrapper.__name__ = getattr(fn, "__name__", "main")
    wrapper.__doc__ = fn.__doc__
    return wrapper
