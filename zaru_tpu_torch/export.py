"""Ahead-of-time export of a tracker step (zaru_tpu/export.py).

``export_fn`` captures a function of tensors (a tracker's ``step`` or the
batch-gated ``step_batch``) with ``torch.export`` and saves the
``ExportedProgram``: the graph, with the tracker's weights baked in, and the
port's kernels as the registered ops ``zaru_tpu_torch::rotated_sample``,
``::letterbox_sample`` and ``::blaze_stage`` (``ops/``). The tracker's
detect-or-keep choice is a ``torch.cond`` (``pipeline/_ops.choose``), so
both branches are in the program, as JAX's ``lax.cond`` is in its
StableHLO. An exported program is specialized to the device it was exported
on (JAX's ``platforms``): the CUDA kernels on ``cuda``, their plain versions
on ``cpu``.

``load_exported``/``deserialize_exported`` reload an artifact with nothing
but this package (no model blobs, no tracker). The returned callable sets
the executor's precision around every call (cuDNN without TF32, f32 matrix
products at full precision, ``onnx/executor.py``) and gives the caller's
settings back afterwards: the settings are process state, not part of a
graph, and without them the card would run the artifact's convolutions in
TF32.

``save_state``/``load_state`` are JAX's pickle-free npz sidecar, format 2
(a JSON tree spec in ``__tree__``, leaves ``leaf_i``, read with
``allow_pickle=False``): a sidecar written by either package loads in the
other. ``write_manifest``/``read_manifest`` write and read JAX's manifest,
with ``"framework": "zaru_tpu_torch"``, ``"torch_version"`` in place of
``"jax_version"`` and ``"platforms"`` the device of the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

__all__ = [
    "Exported",
    "export_fn",
    "load_exported",
    "deserialize_exported",
    "save_state",
    "load_state",
    "write_manifest",
    "read_manifest",
]

_SIDECAR_FORMAT = 2  # zaru_tpu/export.py _SIDECAR_FORMAT: both packages read and write it


class _Step(nn.Module):
    """``fn`` as a module whose submodules (so whose parameters and
    buffers) are the networks ``fn`` reaches: the tracker's weights become
    the program's parameters instead of anonymous constants."""

    def __init__(self, fn, modules: list[nn.Module]):
        super().__init__()
        self.fn = fn
        self.nets = nn.ModuleList(modules)

    def forward(self, *args):
        # While torch.export traces, the parameters and buffers read here
        # are its stand-ins for them: remember which is which, for the
        # branches that read them (_lift_branch_tensors).
        self.traced = {id(t): (name, t) for name, t in (*self.named_parameters(), *self.named_buffers())}
        return self.fn(*args)


def _modules_of(fn, depth: int = 4) -> list[nn.Module]:
    """The ``nn.Module``s reachable from ``fn`` (its bound object, closure,
    defaults and the globals it names) through the attributes of this
    package's objects, each once."""
    found: dict[int, nn.Module] = {}
    seen: set[int] = set()

    def walk(obj, d):
        if id(obj) in seen or d < 0:
            return
        seen.add(id(obj))
        if isinstance(obj, nn.Module):
            found.setdefault(id(obj), obj)
            return
        if isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v, d - 1)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v, d - 1)
        elif type(obj).__module__.startswith(__package__ or "zaru_tpu_torch"):
            for v in vars(obj).values() if hasattr(obj, "__dict__") else ():
                walk(v, d - 1)

    names = getattr(fn, "__code__", None) and fn.__code__.co_names
    roots = [getattr(fn, "__self__", None), *(c.cell_contents for c in fn.__closure__ or ()),
             *(fn.__defaults__ or ()), *(fn.__globals__[n] for n in names or () if n in fn.__globals__)]
    for r in roots:
        if r is not None:
            walk(r, depth)
    return list(found.values())


def _to_tensors(tree, device: torch.device):
    """Every array or tensor leaf of ``tree`` as a tensor on ``device``."""
    return pytree.tree_map(
        lambda v: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(device)
        if isinstance(v, (np.ndarray, np.generic, torch.Tensor)) else v,
        tree,
    )


def _lift_branch_tensors(ep: torch.export.ExportedProgram, traced: dict) -> None:
    """Makes every tensor that a ``torch.cond`` branch reads from its
    closure (the networks' weights, the stage kernel's packed blocks,
    constants made while tracing) an operand of the ``cond``, and at the top
    of the program a parameter (the same one the graph already takes) or a
    lifted constant, so the program serializes: tracing a branch leaves such
    tensors as attributes of the branch's graph, which ``torch.export.save``
    refuses. Nested ``cond``s are lifted first, into their parent branch.
    ``traced``: the stand-ins export traced the parameters and buffers with,
    ``{id: (name, tensor)}`` (``_Step.traced``)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.export.graph_signature import ExportGraphSignature, InputKind, InputSpec, TensorArgument

    gm = ep.graph_module
    fake = detect_fake_mode([n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder"])
    counter = iter(range(1 << 30))

    def free_tensors(g):
        out: dict[int, torch.Tensor] = {}
        for n in g.graph.nodes:
            if n.op == "get_attr" and isinstance(getattr(g, n.target), torch.Tensor):
                out.setdefault(id(getattr(g, n.target)), getattr(g, n.target))
        return out

    def bind(g, tensors: dict[int, torch.Tensor]) -> None:
        """New trailing placeholders of ``g`` for ``tensors``, in their
        order, in place of its attribute reads."""
        last = [n for n in g.graph.nodes if n.op == "placeholder"][-1]
        slots = {}
        for key, t in tensors.items():
            with g.graph.inserting_after(last):
                last = slots[key] = g.graph.placeholder(f"lifted_{next(counter)}")
            last.meta["val"] = fake.from_tensor(t, static_shapes=True)
        read = set()
        for n in list(g.graph.nodes):
            if n.op == "get_attr" and isinstance(getattr(g, n.target), torch.Tensor):
                n.replace_all_uses_with(slots[id(getattr(g, n.target))])
                g.graph.erase_node(n)
                read.add(n.target)
        for name in read:
            delattr(g, name)
        g.recompile()

    def lift_conds(g) -> None:
        for node in list(g.graph.nodes):
            if node.op != "call_function" or node.target is not torch.ops.higher_order.cond:
                continue
            pred, t_node, f_node, operands = node.args
            branches = [getattr(g, t_node.target), getattr(g, f_node.target)]
            for b in branches:
                lift_conds(b)
            tensors = {**free_tensors(branches[0]), **free_tensors(branches[1])}
            if not tensors:
                continue
            for b in branches:
                bind(b, tensors)
            extra = []
            with g.graph.inserting_before(node):
                for t in tensors.values():
                    name = f"_lifted_tensor_{next(counter)}"
                    g.register_buffer(name, t, persistent=False)
                    extra.append(g.graph.get_attr(name))
                    extra[-1].meta["val"] = fake.from_tensor(t, static_shapes=True)
            node.args = (pred, t_node, f_node, (*operands, *extra))
        g.recompile()

    lift_conds(gm)
    # The top graph: a parameter or buffer the program already takes is
    # read from its placeholder; any other tensor becomes a lifted constant.
    sig = ep.graph_signature
    placeholders = {n.name: n for n in gm.graph.nodes if n.op == "placeholder"}

    def key(t: torch.Tensor):
        """A parameter or buffer as export traced it (a fake tensor, what a
        branch read) by its name; a real tensor by its memory and the way
        it is read."""
        if isinstance(t, FakeTensor):
            return traced[id(t)][0] if id(t) in traced else id(t)
        return t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), t.stride(), t.dtype

    known = {}
    for spec in sig.input_specs:
        if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR):
            ph = placeholders[spec.arg.name]
            known[spec.target] = ph
            value = ep.state_dict.get(spec.target, ep.constants.get(spec.target))
            if isinstance(value, torch.Tensor):
                known.setdefault(key(value), ph)
    specs = list(sig.input_specs)
    first_user = next(i for i, s in enumerate(specs) if s.kind == InputKind.USER_INPUT)
    first_user_node = placeholders[specs[first_user].arg.name]
    read = set()
    for n in list(gm.graph.nodes):
        if n.op != "get_attr" or not isinstance(getattr(gm, n.target), torch.Tensor):
            continue
        t = getattr(gm, n.target)
        if isinstance(t, FakeTensor) and key(t) not in known:
            raise RuntimeError(f"a branch of the program reads a traced tensor that is no input of it: {n.target}")
        if key(t) not in known:
            target = f"lifted_branch_tensor_{len(ep.constants)}"
            with gm.graph.inserting_before(first_user_node):
                ph = gm.graph.placeholder(target)
            ph.meta["val"] = fake.from_tensor(t, static_shapes=True)
            ep.constants[target] = t
            specs.insert(first_user, InputSpec(InputKind.CONSTANT_TENSOR, TensorArgument(ph.name), target, None))
            first_user += 1
            known[key(t)] = ph
        n.replace_all_uses_with(known[key(t)])
        gm.graph.erase_node(n)
        read.add(n.target)
    for name in read:
        delattr(gm, name)
    gm.recompile()
    ep._graph_signature = ExportGraphSignature(input_specs=specs, output_specs=list(sig.output_specs))


def export_fn(fn, args, path: str | Path, *, device=None) -> torch.export.ExportedProgram:
    """Exports ``fn(*args)`` with ``torch.export`` to ``path`` and returns
    the program. ``args``: a tuple of tensors or nested dicts/lists of them
    (numpy arrays are taken as tensors), moved to ``device`` (left out: the
    device of the first tensor). The networks ``fn`` reaches must be on that
    device: the program is specialized to it."""
    from . import ops  # noqa: F401  registers the kernels' ops

    if device is None:
        first = next(v for v in pytree.tree_leaves(args) if isinstance(v, (np.ndarray, torch.Tensor)))
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    device = torch.device(device)
    args = _to_tensors(tuple(args), device)
    modules = _modules_of(fn)
    for m in modules:
        for t in (*m.parameters(), *m.buffers()):
            if t.device.type != device.type:
                raise ValueError(f"the networks are on {t.device}, the program is exported for {device}")
    step = _Step(fn, modules)
    with torch.no_grad():
        ep = torch.export.export(step, args, strict=False)
    _lift_branch_tensors(ep, step.traced)
    del step.traced
    ep.example_inputs = None  # not saved: at batch 512 of 1080p the frames alone are 4.2 GB
    torch.export.save(ep, str(path))
    return ep


@dataclass
class Exported:
    """A reloaded artifact: ``program`` (the ``ExportedProgram``), ``call``
    (its function of the exported arguments, see :func:`load_exported`),
    ``in_specs`` (each flat user input's ``(shape, numpy dtype name)``, in
    order) and ``device``."""

    program: torch.export.ExportedProgram
    call: object
    in_specs: list
    device: torch.device


def deserialize_exported(path: str | Path) -> Exported:
    """Loads an artifact of :func:`export_fn` with its input signature, so a
    caller can validate frames and a state sidecar before the first call."""
    from . import ops  # noqa: F401  the kernels' ops must be registered before loading
    from .onnx.executor import _full_precision

    ep = torch.export.load(str(path))
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    vals = [nodes[name].meta["val"] for name in ep.graph_signature.user_inputs]
    in_specs = [(tuple(int(d) for d in v.shape), _np_dtype(v.dtype)) for v in vals]
    device = vals[0].device if vals else torch.device("cpu")
    module = ep.module()

    def call(*args):
        with torch.inference_mode(), _full_precision():
            return module(*_to_tensors(args, device))

    return Exported(ep, call, in_specs, device)


def load_exported(path: str | Path):
    """Loads an exported step; returns a callable of the original arguments
    (numpy arrays or tensors; they go to the program's device), which sets
    the executor's precision for the call and restores the caller's."""
    return deserialize_exported(path).call


def _np_dtype(dtype: torch.dtype) -> str:
    return torch.empty((), dtype=dtype).numpy().dtype.name


# --------------------------------------------------------------------------
# State sidecar: a pickle-free tree <-> npz codec (zaru_tpu/export.py:83).
# --------------------------------------------------------------------------


def _encode_tree(obj, leaves: list) -> dict:
    """A tree of dict/list/tuple/None containers as a JSON-able spec, its
    array or tensor leaves appended to ``leaves`` as numpy arrays in order.
    Empty containers are structure and are kept."""
    if obj is None:
        return {"kind": "none"}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"state sidecars require string dict keys, got {keys!r}")
        return {"kind": "dict", "keys": keys, "children": [_encode_tree(obj[k], leaves) for k in keys]}
    if isinstance(obj, (list, tuple)):
        return {"kind": "list" if isinstance(obj, list) else "tuple",
                "children": [_encode_tree(v, leaves) for v in obj]}
    leaves.append(obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj))
    return {"kind": "leaf", "i": len(leaves) - 1}


def _decode_tree(spec: dict, leaves):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _decode_tree(c, leaves) for k, c in zip(spec["keys"], spec["children"])}
    if kind == "list":
        return [_decode_tree(c, leaves) for c in spec["children"]]
    if kind == "tuple":
        return tuple(_decode_tree(c, leaves) for c in spec["children"])
    if kind == "leaf":
        return leaves[spec["i"]]
    raise ValueError(f"unknown sidecar tree node kind {kind!r}")


def save_state(state, path: str | Path) -> None:
    """Saves a tree of tensors or arrays (e.g. ``tracker.init_state()``) as
    one npz: only arrays and a JSON structure spec, nothing executable. The
    file is written through a handle, so a path without ``.npz`` keeps its
    name."""
    leaves: list = []
    spec = _encode_tree(state, leaves)
    with open(Path(path), "wb") as f:
        np.savez(
            f,
            __format__=np.int64(_SIDECAR_FORMAT),
            __tree__=np.str_(json.dumps(spec, separators=(",", ":"))),
            **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
        )


def load_state(path: str | Path):
    """Loads a tree saved by :func:`save_state` (or by JAX's), leaves as
    numpy arrays. Opened with ``allow_pickle=False``: a legacy or tampered
    pickle-bearing sidecar is refused, never executed."""
    with np.load(Path(path), allow_pickle=False) as data:
        if "__treedef__" in data.files:
            raise ValueError(
                f"{path} is a legacy pickle-based state sidecar; re-export the artifact "
                "(python -m zaru_tpu_torch export) to produce the pickle-free format"
            )
        if "__tree__" not in data.files or "__format__" not in data.files:
            raise ValueError(f"{path} is not a zaru_tpu state sidecar")
        version = int(data["__format__"])
        if version != _SIDECAR_FORMAT:
            raise ValueError(
                f"{path}: unsupported sidecar format {version} (this build reads format {_SIDECAR_FORMAT})"
            )
        spec = json.loads(str(data["__tree__"]))
        leaves = [data[f"leaf_{i}"] for i in range(sum(1 for f in data.files if f.startswith("leaf_")))]
        return _decode_tree(spec, leaves)


# --------------------------------------------------------------------------
# Artifact manifest (zaru_tpu/export.py:189).
# --------------------------------------------------------------------------


def manifest_path(artifact: str | Path) -> Path:
    return Path(f"{artifact}.manifest.json")


def write_manifest(
    artifact: str | Path,
    *,
    pipeline: str,
    kind: str,
    batch: int,
    frame_shape,
    frame_dtype: str,
    platforms,
    state_leaves: int,
) -> Path:
    """Writes ``{artifact}.manifest.json``: what frames the step accepts,
    the device it was exported for (``platforms``) and the package and
    torch versions that made it, checked by ``run-exported`` before any
    device work."""
    import datetime

    from . import __version__

    path = manifest_path(artifact)
    meta = {
        "format": 1,
        "framework": "zaru_tpu_torch",
        "framework_version": __version__,
        "torch_version": torch.__version__,
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
        "pipeline": pipeline,
        "kind": kind,
        "batch": int(batch),
        "frame_shape": [int(d) for d in frame_shape],
        "frame_dtype": str(frame_dtype),
        "platforms": [str(p) for p in platforms] if platforms else None,
        "state_leaves": int(state_leaves),
        "artifact": Path(artifact).name,
    }
    path.write_text(json.dumps(meta, indent=2) + "\n")
    return path


def read_manifest(artifact: str | Path) -> dict | None:
    """Reads ``{artifact}.manifest.json`` if present; None otherwise."""
    path = manifest_path(artifact)
    if not path.exists():
        return None
    return json.loads(path.read_text())
