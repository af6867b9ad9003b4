"""Static spatial-footprint derivation: an offset-interval abstract
interpreter over aten graphs. The port's counterpart of
``heat2d_tpu/analysis/footprint.py`` (which walks jaxprs).

``FamilySpec.halo_width`` (``problems/base.py``) is a declared contract:
it sets the ring every sweep of H2/H3/H6/H9 recomputes (``W * T`` cells
deep), the boundary ring every step holds, and the seam geometry of the
sharded routes. This module derives the true spatial access radius of a
step from the graph it traces to, so the declaration is checked against
the code (``analysis/ir.py``).

Tracing: ``trace(fn, *args)`` runs ``make_fx`` on CPU tensors (a real
trace: the function runs once, eagerly, on the host; it launches no
kernel, and the suite pins that the traced outputs are bitwise those of
an untraced call). A ``_Provenance`` dispatch mode rides above the
tracer and stamps each node with the Python frames that made it, which
the dtype census (``analysis/dtype_flow.py``) reports.

Abstract domain: per graph value, per axis, an offset interval ``[lo,
hi]`` meaning "element ``j`` depends on tracked-input elements in ``[j +
lo, j + hi]``". The tracked input (the state grid ``u``) starts at ``[0,
0]``; values with no dependence on it are BOT (coefficient fields,
masks, scalars); anything the domain cannot express is TOP, carrying the
op that caused it (an underivable footprint is a finding, never a silent
pass). Every bound remembers the op that last widened it, so a finding
names the culprit.

Transfer rules: ``slice``, ``constant_pad_nd``, ``cat``, ``roll`` (both
pieces of the wraparound), ``select`` and ``index`` with constant
indices, ``permute``/``transpose``, unit-axis ``unsqueeze``/``squeeze``/
``view``, ``copy_`` into a slice view (how the port writes a step's
interior), ``convolution`` with a constant kernel, and elementwise ops
(scalar operands and broadcast constants are BOT; a broadcast of a
dependent value is TOP). Any other op on a dependent value is TOP.

Coefficient reads: the distinct grid-shaped float values with no
dependence on ``u`` that feed a dependent op, each counted once across
its views (two slices of one field are one read). ``1 + coef_reads`` is
the static witness for ``FamilySpec.reads_per_step``, which the
roofline's bytes per cell-step streams (``obs/roofline.py``).
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: elementwise ops: the output's dependence is the join of the operands'
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "maximum", "minimum",
    "pow", "exp", "log", "tanh", "sqrt", "rsqrt", "abs", "sign", "floor",
    "ceil", "round", "remainder", "fmod", "where", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "eq", "ne",
    "lt", "le", "gt", "ge", "square", "sigmoid", "erf", "sin", "cos",
    "atan2", "clamp", "clamp_min", "clamp_max", "isfinite", "addcmul",
    "addcdiv", "lerp", "reciprocal", "_to_copy", "to", "clone", "alias",
    "detach", "lift_fresh_copy", "masked_fill", "fill", "copy",
}

#: ops whose output carries no dependence whatever the inputs hold
SOURCES = {"zeros_like", "empty_like", "ones_like", "full_like", "zeros",
           "ones", "empty", "full", "arange", "scalar_tensor",
           "empty_strided", "new_zeros", "new_empty", "new_full",
           "new_ones"}

#: ops that are views of their first operand (coefficient-read dedup)
VIEW_OPS = {"slice", "select", "_to_copy", "to", "lift_fresh_copy",
            "clone", "alias", "detach", "unsqueeze", "squeeze", "view",
            "_unsafe_view", "reshape", "expand", "permute", "t",
            "transpose"}


class _Top:
    """Underivable dependence; remembers the op that caused it."""

    __slots__ = ("why",)

    def __init__(self, why: str):
        self.why = why

    def __repr__(self):
        return f"TOP({self.why})"


@dataclasses.dataclass(frozen=True)
class Interval:
    """Per-axis offset intervals with the op that set each bound."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    wit_lo: Tuple[str, ...]
    wit_hi: Tuple[str, ...]

    @classmethod
    def zero(cls, rank: int, wit: str = "input") -> "Interval":
        return cls((0,) * rank, (0,) * rank, (wit,) * rank, (wit,) * rank)

    @property
    def rank(self) -> int:
        return len(self.lo)

    def shift(self, axis: int, delta: int, wit: str) -> "Interval":
        return self.widen(axis, delta, delta, wit)

    def widen(self, axis: int, lo: int, hi: int, wit: str) -> "Interval":
        """Bounds of ``axis`` moved by ``lo`` and ``hi``; a bound that
        moves is re-witnessed by ``wit``."""
        nlo, nhi = list(self.lo), list(self.hi)
        wl, wh = list(self.wit_lo), list(self.wit_hi)
        nlo[axis] += int(lo)
        nhi[axis] += int(hi)
        if lo:
            wl[axis] = wit
        if hi:
            wh[axis] = wit
        return Interval(tuple(nlo), tuple(nhi), tuple(wl), tuple(wh))

    def permute(self, perm) -> "Interval":
        return Interval(tuple(self.lo[p] for p in perm),
                        tuple(self.hi[p] for p in perm),
                        tuple(self.wit_lo[p] for p in perm),
                        tuple(self.wit_hi[p] for p in perm))


def _join(a, b):
    """Lattice join. ``None`` is BOT; ``_Top`` dominates."""
    if isinstance(a, _Top):
        return a
    if isinstance(b, _Top):
        return b
    if a is None:
        return b
    if b is None:
        return a
    if a.rank != b.rank:
        return _Top("rank-mismatched join")
    lo, hi, wl, wh = [], [], [], []
    for i in range(a.rank):
        x, wx = (a.lo[i], a.wit_lo[i]) if a.lo[i] <= b.lo[i] else \
            (b.lo[i], b.wit_lo[i])
        y, wy = (a.hi[i], a.wit_hi[i]) if a.hi[i] >= b.hi[i] else \
            (b.hi[i], b.wit_hi[i])
        lo.append(x)
        wl.append(wx)
        hi.append(y)
        wh.append(wy)
    return Interval(tuple(lo), tuple(hi), tuple(wl), tuple(wh))


@dataclasses.dataclass
class FootprintResult:
    """Derived dependence of a program's first output on its tracked
    input tensor."""

    #: per-axis (lo, hi) offsets, or None when underivable
    lo: Optional[Tuple[int, ...]]
    hi: Optional[Tuple[int, ...]]
    #: op that set each bound (names the culprit in findings)
    wit_lo: Tuple[str, ...]
    wit_hi: Tuple[str, ...]
    #: when not None: the op the domain could not express
    top: Optional[str]
    #: distinct grid-shaped values without input dependence feeding
    #: dependent arithmetic (coefficient fields)
    coef_reads: int

    @property
    def derivable(self) -> bool:
        return self.top is None and self.lo is not None

    def radius(self, axis: int) -> int:
        """max(-lo, hi, 0): the access radius along ``axis``."""
        assert self.lo is not None and self.hi is not None
        return max(-self.lo[axis], self.hi[axis], 0)

    def radii(self) -> Tuple[int, ...]:
        assert self.lo is not None
        return tuple(self.radius(a) for a in range(len(self.lo)))

    def witness(self, axis: int) -> str:
        """The op responsible for the widest offset on ``axis``."""
        assert self.lo is not None and self.hi is not None
        if -self.lo[axis] >= self.hi[axis]:
            return self.wit_lo[axis]
        return self.wit_hi[axis]


# --------------------------------------------------------------------- #
# Tracing with provenance
# --------------------------------------------------------------------- #

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_HERE = os.path.abspath(__file__)


def _user_frames(root_code) -> List[traceback.FrameSummary]:
    """The Python frames from the traced function's own frame inward,
    without torch's or this module's."""
    frames = traceback.extract_stack()
    start = 0
    for i, fr in enumerate(frames):
        if (fr.filename == root_code.co_filename
                and fr.name == root_code.co_name):
            start = i
            break
    return [fr for fr in frames[start:]
            if not os.path.abspath(fr.filename).startswith(_TORCH_DIR)
            and os.path.abspath(fr.filename) != _HERE]


def _site(fr: traceback.FrameSummary) -> str:
    path = os.path.abspath(fr.filename)
    if path.startswith(_PKG_ROOT + os.sep):
        path = os.path.relpath(path, _PKG_ROOT)
    else:
        path = os.path.basename(path)
    return f"{path.replace(os.sep, '/')}:{fr.lineno}"


class _Provenance(torch.utils._python_dispatch.TorchDispatchMode):
    """Stamps every node the tracer adds during one dispatched op with
    ``meta['provenance'] = (path, site)``: the function names from the
    traced root inward (the root excluded) and the innermost frame's
    ``module:line``."""

    def __init__(self, root_code):
        super().__init__()
        self.root_code = root_code

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.fx.experimental.proxy_tensor import get_proxy_mode
        mode = get_proxy_mode()
        graph = mode.tracer.graph if mode is not None else None
        before = len(graph.nodes) if graph is not None else 0
        out = func(*args, **(kwargs or {}))
        if graph is not None and len(graph.nodes) > before:
            frames = _user_frames(self.root_code)
            path = tuple(fr.name for fr in frames[1:])
            site = _site(frames[-1]) if frames else "?"
            for node in list(graph.nodes)[before:]:
                node.meta.setdefault("provenance", (path, site))
        return out


def trace(fn, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` traced to an aten graph on the host (``make_fx``),
    each node stamped with its provenance. The arguments must be CPU
    tensors: the trace runs ``fn`` once, and a CPU tensor makes every
    wrapper of the port take its plain version."""
    from torch.fx.experimental.proxy_tensor import make_fx
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            raise ValueError(f"trace: arguments must lie on the CPU, got "
                             f"{a.device} (a card's tensor would launch "
                             f"the kernels)")
    root = getattr(fn, "__code__", None)

    def traced(*a):
        if root is None:
            return fn(*a)
        with _Provenance(root):
            return fn(*a)

    return make_fx(traced)(*args)


def op_name(node) -> str:
    """An aten node's op name without namespace or overload
    (``aten.slice.Tensor`` -> ``slice``)."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


# --------------------------------------------------------------------- #
# The interpreter
# --------------------------------------------------------------------- #

def _val(node):
    """The example value the tracer recorded for ``node``."""
    return node.meta.get("val") if hasattr(node, "meta") else None


def _shape(node) -> Optional[Tuple[int, ...]]:
    v = _val(node)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def _norm(i, n) -> int:
    """A python slice bound on an axis of ``n``: negatives from the end,
    clamped to [0, n]."""
    if i is None:
        return 0
    i = int(i)
    if i < 0:
        i += n
    return min(max(i, 0), n)


def _axis_map(old, new) -> Optional[Dict[int, int]]:
    """old axis -> new axis for reshapes that only insert or remove unit
    axes; None for genuine reshapes."""
    old_nz = [(i, d) for i, d in enumerate(old) if d != 1]
    new_nz = [(i, d) for i, d in enumerate(new) if d != 1]
    if [d for _, d in old_nz] != [d for _, d in new_nz]:
        return None
    return {o: n for (o, _), (n, _) in zip(old_nz, new_nz)}


def _remap(v: Interval, amap, new_rank: int, wit: str):
    """Intervals carried through a unit-axis reshape; a dropped axis must
    carry no offset."""
    lo, hi = [0] * new_rank, [0] * new_rank
    wl, wh = [wit] * new_rank, [wit] * new_rank
    for o in range(v.rank):
        if o in amap:
            n = amap[o]
            lo[n], hi[n] = v.lo[o], v.hi[o]
            wl[n], wh[n] = v.wit_lo[o], v.wit_hi[o]
        elif v.lo[o] or v.hi[o]:
            return _Top(wit)
    return Interval(tuple(lo), tuple(hi), tuple(wl), tuple(wh))


class _Interp:
    def __init__(self, gm: torch.fx.GraphModule, track: int,
                 interior_margin: int):
        self.gm = gm
        self.env: Dict[object, object] = {}
        self.const: Dict[object, torch.Tensor] = {}
        #: node -> the node it is a view of (slices, casts, copies)
        self.view_parent: Dict[object, object] = {}
        #: node -> (base node, per-axis start offsets) for slice views
        self.slice_of: Dict[object, Tuple[object, Tuple[int, ...]]] = {}
        self.coef_roots: Dict[object, Tuple[int, ...]] = {}
        self.track = track
        self.min_interior = None
        self.margin = interior_margin

    # -- plumbing ---------------------------------------------------- #

    def read(self, a):
        return self.env.get(a) if isinstance(a, torch.fx.Node) else None

    def root_of(self, node):
        seen = set()
        while node in self.view_parent and node not in seen:
            seen.add(node)
            node = self.view_parent[node]
        return node

    def root_key(self, node):
        """The identity of a value's view root: the node, or for a
        constant the storage it reads (the tracer gives each use of one
        captured tensor a constant node of its own)."""
        root = self.root_of(node)
        c = self.const.get(root)
        if root.op == "get_attr" and isinstance(c, torch.Tensor):
            return ("storage", c.untyped_storage().data_ptr())
        return root

    def note_coef_reads(self, node) -> None:
        """Grid-shaped float operands of a dependent op that carry no
        dependence: coefficient-field reads, keyed by their view root."""
        if self.min_interior is None:
            return
        for a in node.all_input_nodes:
            shape = _shape(a)
            v = _val(a)
            if shape is None or len(shape) < len(self.min_interior):
                continue
            if not v.dtype.is_floating_point:
                continue
            tail = shape[len(shape) - len(self.min_interior):]
            if any(d < m for d, m in zip(tail, self.min_interior)):
                continue
            if self.read(a) is None:
                self.coef_roots[self.root_key(a)] = shape

    # -- the walk ---------------------------------------------------- #

    def run(self):
        placeholders = [n for n in self.gm.graph.nodes
                        if n.op == "placeholder"]
        tracked = placeholders[self.track]
        shape = _shape(tracked)
        self.min_interior = tuple(max(1, d - self.margin) for d in shape)
        self.env[tracked] = Interval.zero(len(shape))
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "get_attr":
                self.const[node] = getattr(self.gm, node.target)
            elif node.op == "call_function":
                self.eval_node(node)
            elif node.op == "output":
                res = node.args[0]
                first = res[0] if isinstance(res, (list, tuple)) else res
                out = self.read(first)
        return out

    def eval_node(self, node) -> None:
        name = op_name(node)
        args = node.args
        if (name in VIEW_OPS and args and isinstance(args[0], torch.fx.Node)):
            self.view_parent[node] = args[0]
        if name in ("lift_fresh_copy", "clone", "_to_copy", "to", "detach",
                    "alias") and args and args[0] in self.const:
            self.const[node] = self.const[args[0]]
        deps = [self.read(a) for a in node.all_input_nodes]
        out = self.transfer(node, name)
        if any(isinstance(d, Interval) for d in deps):
            self.note_coef_reads(node)
        self.env[node] = out

    def transfer(self, node, name):
        args, kw = node.args, node.kwargs
        ins = [self.read(a) for a in node.all_input_nodes]
        if name == "copy_":
            return self._copy_(node)
        if name == "slice":
            self._note_slice(node)
        if not any(v is not None for v in ins):
            return None
        top = next((v for v in ins if isinstance(v, _Top)), None)
        if top is not None:
            return top
        if name in SOURCES:
            return None
        out_shape = _shape(node)

        if name in ELEMENTWISE:
            out = None
            for a in node.all_input_nodes:
                v = self.read(a)
                if v is None:
                    continue
                shape = _shape(a)
                if (out_shape is None or shape is None
                        or len(shape) != len(out_shape)
                        or any(d1 == 1 and d2 != 1
                               for d1, d2 in zip(shape, out_shape))):
                    return _Top(name)     # a dependent value broadcast
                out = _join(out, v)
            return out

        v = self.read(args[0])
        if name == "slice":
            dim, start = args[1], args[2] if len(args) > 2 else None
            step = args[4] if len(args) > 4 else 1
            if step != 1:
                return _Top("slice[strided]")
            n = _shape(args[0])[dim]
            return v.shift(dim % v.rank, _norm(start, n), "slice")

        if name == "constant_pad_nd":
            pad = list(args[1])
            for k in range(len(pad) // 2):
                axis = v.rank - 1 - k
                v = v.shift(axis, -int(pad[2 * k]), "constant_pad_nd")
            return v

        if name == "cat":
            dim = (args[1] if len(args) > 1 else kw.get("dim", 0))
            out, offset = None, 0
            for a in args[0]:
                a_shape = _shape(a)
                part = self.read(a)
                if part is not None:
                    out = _join(out, part.shift(dim % part.rank, -offset,
                                                "cat"))
                offset += a_shape[dim]
            return out

        if name == "roll":
            shifts, dims = list(args[1]), list(args[2]) if len(args) > 2 \
                else []
            if not dims:
                return _Top("roll[flattened]")
            shape = _shape(args[0])
            for s, d in zip(shifts, dims):
                d %= v.rank
                s = int(s) % shape[d]
                if s:     # out[j] = in[j - s], wrapping to in[j - s + n]
                    v = v.widen(d, -s, shape[d] - s, "roll")
            return v

        if name in ("permute",):
            return v.permute([int(p) % v.rank for p in args[1]])

        if name in ("t", "transpose"):
            a, b = (0, 1) if name == "t" else (args[1] % v.rank,
                                                args[2] % v.rank)
            perm = list(range(v.rank))
            perm[a], perm[b] = perm[b], perm[a]
            return v.permute(perm)

        if name == "select":
            dim = args[1] % v.rank
            if v.lo[dim] or v.hi[dim]:
                return _Top("select")
            keep = [a for a in range(v.rank) if a != dim]
            return Interval(tuple(v.lo[a] for a in keep),
                            tuple(v.hi[a] for a in keep),
                            tuple(v.wit_lo[a] for a in keep),
                            tuple(v.wit_hi[a] for a in keep))

        if name == "index":
            return self._index(node, v)

        if name in ("unsqueeze", "squeeze", "view", "_unsafe_view",
                    "reshape"):
            old, new = _shape(args[0]), out_shape
            amap = _axis_map(old, new)
            if amap is None:
                return _Top(name)
            return _remap(v, amap, len(new), name)

        if name == "convolution":
            return self._conv(node, v)

        return _Top(name)

    # -- the rules with state ---------------------------------------- #

    def _note_slice(self, node) -> None:
        """Record a slice view's base and start offsets, composed through
        slices of slices, for ``copy_`` into it."""
        base = node.args[0]
        shape = _shape(base)
        dim = node.args[1] % len(shape)
        start = _norm(node.args[2] if len(node.args) > 2 else None,
                      shape[dim])
        if base in self.slice_of:
            root, offs = self.slice_of[base]
        else:
            root, offs = base, (0,) * len(shape)
        offs = list(offs)
        offs[dim] += start
        self.slice_of[node] = (root, tuple(offs))

    def _copy_(self, node):
        """``dst.copy_(src)`` where ``dst`` is a slice view of a base:
        the base now also holds ``src`` at the view's offsets. Returns
        the view's value (the op's own result)."""
        dst, src = node.args[0], node.args[1]
        sv = self.read(src)
        root, offs = self.slice_of.get(dst, (dst, None))
        if sv is not None and not isinstance(sv, _Top):
            if (_shape(src) != _shape(dst)
                    or (offs is None and dst is not root)):
                sv = _Top("copy_[broadcast]")
            elif offs is not None:
                for axis, o in enumerate(offs):
                    sv = sv.shift(axis, -o, "copy_")
        if sv is not None:
            self.env[root] = _join(self.env.get(root), sv)
            if not isinstance(sv, _Top) and isinstance(
                    self.env.get(root), Interval):
                self.note_coef_reads(node)
        return self.read(dst) if sv is None else _join(self.read(dst), sv)

    def _index(self, node, v):
        """``x[..., idx, ...]`` with one constant 1D index tensor: output
        j on that axis reads input ``idx[j]``, offsets ``idx[j] - j``."""
        idx = list(node.args[1])
        live = [(k, a) for k, a in enumerate(idx) if a is not None]
        if len(live) != 1:
            return _Top("index")
        axis, a = live[0]
        c = self.const.get(a)
        if c is None or c.dim() != 1 or c.dtype.is_floating_point:
            return _Top("index[traced indices]")
        n = _shape(node.args[0])[axis]
        c = torch.where(c < 0, c + n, c).to(torch.int64).numpy()
        off = c - np.arange(len(c))
        return v.widen(axis, int(off.min()), int(off.max()), "index")

    def _conv(self, node, v):
        """Stride-1 convolution with a constant kernel: out[j] reads
        in[j - pad .. j - pad + (k - 1) dil] on each spatial axis."""
        args = node.args
        if self.read(args[1]) is not None:
            return _Top("convolution[traced kernel]")
        stride, padding, dilation = args[3], args[4], args[5]
        transposed, groups = args[6], args[8]
        if transposed or any(s != 1 for s in stride):
            return _Top("convolution[strided or transposed]")
        k_shape = _shape(args[1])
        if v.lo[0] or v.hi[0] or v.lo[1] or v.hi[1] or (
                k_shape[1] * groups != 1):
            return _Top("convolution[channels]")
        for i in range(len(stride)):
            axis = 2 + i
            reach = (k_shape[axis] - 1) * dilation[i]
            v = v.widen(axis, -padding[i], reach - padding[i],
                        "convolution")
        return v


def derive_footprint(fn, *example_args, track: int = 0,
                     interior_margin: int = 8) -> FootprintResult:
    """Trace ``fn(*example_args)`` (``trace``) and derive its first
    output's dependence on positional argument ``track`` (the state
    grid). ``interior_margin``: a value counts as a coefficient read only
    when its trailing dims are within ``interior_margin`` of the tracked
    input's (grid- or interior-sized, not a reduced summary)."""
    gm = trace(fn, *example_args)
    return footprint_of_graph(gm, track, interior_margin)


def footprint_of_graph(gm, track: int = 0,
                       interior_margin: int = 8) -> FootprintResult:
    """``derive_footprint`` on a graph already traced."""
    interp = _Interp(gm, track, interior_margin)
    out = interp.run()
    coef = len(interp.coef_roots)
    rank = len(interp.min_interior)
    if isinstance(out, _Top):
        return FootprintResult(None, None, (), (), out.why, coef)
    if out is None:
        return FootprintResult((0,) * rank, (0,) * rank, ("none",) * rank,
                               ("none",) * rank, None, coef)
    return FootprintResult(out.lo, out.hi, out.wit_lo, out.wit_hi, None,
                           coef)
