"""The gallery of a configuration that identifies the faces it tracks, made
from the configuration alone (its ``gallery`` section)::

    "gallery": {"rows": G, "dim": D, "seed": n,
                "enroll": [{"network": "<networks name>", "rect": [cx, cy, w, h, angle]}, ...]}

:func:`rows` gives ``(names, [G,D] float32)`` on the CPU:

- the enrolled rows first, one an ``enroll`` entry: the output of the
  configuration's further network of that name (its ``networks`` entry),
  run by the plain graph runner and L2-normalised, on the entry's rect
  (pixels and radians) of the untransformed bench frame
  (:func:`benchmark.harness.frames.bench_frame`), cut by the reference's
  exact sampler at the network's input size, in the colour range of the
  configuration's section named as the network (``config[network]
  ["color_range"]``);
- then ``G`` less the enrolled rows drawn from ``seed``: standard Gaussian
  rows, each scaled to unit length.

Names are ``enrolled.<i>`` and ``seeded.<i>``. The rows are made once a
process and handed out as copies: the harness installs them in the program
(``set_gallery(names, rows)``) during set-up, and a reference module gets
the same rows from the same call. The program never computes them.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from ..reference import samplers
from ..reference.graph import Graph
from .frames import bench_frame

__all__ = ["rows"]


def rows(config: dict, model_dir) -> tuple[list[str], torch.Tensor]:
    """``(names, [G,D] float32 on the CPU)`` of ``config``'s gallery; the
    networks are read from ``model_dir``."""
    spec = config["gallery"]
    files = {net["name"]: net["file"] for net in config.get("networks", [])}
    enroll = tuple((files[e["network"]], tuple(config[e["network"]]["color_range"]), tuple(e["rect"]))
                   for e in spec["enroll"])
    names, made = _made(int(spec["rows"]), int(spec["dim"]), int(spec["seed"]), enroll, str(model_dir))
    return list(names), made.clone()


def _unit(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


@functools.lru_cache(maxsize=4)
def _made(count: int, dim: int, seed: int, enroll: tuple, model_dir: str) -> tuple[tuple, torch.Tensor]:
    if len(enroll) > count:
        raise ValueError(f"a gallery of {count} rows cannot hold {len(enroll)} enrolled ones")
    frame = torch.from_numpy(bench_frame())[None]
    graphs, enrolled = {}, []
    for file, (lo, hi), rect in enroll:
        if file not in graphs:
            graphs[file] = Graph(Path(model_dir) / file)
        net = graphs[file]
        h, w = net.input_shape[2:]
        x = samplers.rotated_exact(frame, torch.tensor([rect], dtype=torch.float32), w, h, lo, hi)
        out = net(x)[0].reshape(-1)
        if out.numel() != dim:
            raise ValueError(f"{file} gives {out.numel()} numbers a face, not the gallery's {dim}")
        enrolled.append(_unit(out))
    z = np.random.Generator(np.random.PCG64(seed)).standard_normal((count - len(enroll), dim))
    seeded = _unit(torch.from_numpy(z)).float()
    names = tuple(f"enrolled.{i}" for i in range(len(enroll))) + tuple(f"seeded.{i}" for i in range(len(seeded)))
    return names, torch.cat([torch.stack(enrolled) if enrolled else seeded[:0], seeded])
