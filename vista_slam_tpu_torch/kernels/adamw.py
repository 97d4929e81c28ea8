"""Kernels K5 and K4: the fused clipped AdamW step with bf16 moments and
with int8 moments, hand-written for Hopper.

Ports of the TPU kernels ``vista_slam_tpu/ops/pallas/adam8.py:
_adam_kernel_bf16`` (K5, entry ``fused_adamw_bf16``, CUDA source
``csrc/adamw_bf16.cu``) and ``_adam_kernel_int8`` (K4, entry
``fused_adamw_int8``, CUDA source ``csrc/adamw_int8.cu``). Each source's
header says what bounds it on the card and how the design answers that.

``fused_adamw_bf16(p, g, mu, nu, scalars, b1=, b2=, eps=, wd=)`` updates one
parameter leaf in place: p and g fp32, mu and nu bf16 with p's number of
elements (any shape; the optimizer keeps them as [C, 1024] like the JAX
package), scalars fp32 [4] = (clip coefficient, lr, 1 - b1^t, 1 - b2^t) on
p's device. Tensors on the CPU go to ``fused_adamw_bf16_plain``, the same
function in plain PyTorch; CUDA tensors go to the kernel or raise.
``LAUNCHES`` counts K5's launches (and nothing else).

``fused_adamw_int8(p, g, mu_q, mu_s, nu_q, nu_s, scalars, b1=, b2=, eps=,
wd=)`` updates one leaf in place: p and g are fp32 views of the leaf in the
JAX package's layout (``models/convert.py::jax_layouts``: a Linear
weight's, a conv's, a transposed conv's or the identity, as
``int8_layout`` describes them; the same shape and strides for both),
whose row-major flatten is cut into C rows of ``QBLOCK`` elements; mu_q and
nu_q int8 [C, QBLOCK] (linear and log-domain codes), mu_s and nu_s fp32
[C, 1] (their row scales); scalars as above. ``fused_adamw_int8_many(
leaves, scalars, b1=, b2=, eps=)`` does the same for a list of leaves
``(p, g, mu_q, mu_s, nu_q, nu_s, wd)`` in one launch per pass, and
``Int8Table`` keeps that list's table for repeated steps (the optimizer's
path). CPU tensors go to ``fused_adamw_int8_plain``, leaf by leaf; CUDA
tensors go to the kernel or raise. ``LAUNCHES_INT8`` counts K4's launches:
``INT8_PASSES`` per call and chunk of leaves.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .build import BuiltLibrary, build

SOURCE = "adamw_bf16.cu"
SOURCE_INT8 = "adamw_int8.cu"
QBLOCK = 1024           # K4's quantization block: one row of the leaf's view
NU_LOG_RANGE = 13.8155  # ln(1e6): nu's log-domain codes span 6 decades

LAUNCHES = 0       # K5
LAUNCHES_INT8 = 0  # K4
INT8_PASSES = 3    # K4's launches per call (and per chunk of leaves)
_built: BuiltLibrary | None = None
_built_int8: BuiltLibrary | None = None
# K4's tile (elements), leaves per launch and largest log2 extent of a tile
# along the torch-contiguous run (from load_int8())
_tile = _max_leaves = _max_lg_tr = 0


def load() -> BuiltLibrary:
    """Build (first call only) and load the kernel library."""
    global _built
    if _built is None:
        built = build(SOURCE)
        fn = built.lib.adamw_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _built = built
    return _built


def load_int8() -> BuiltLibrary:
    """Build (first call only) and load K4's library; reads its tile size
    and the leaves one launch takes from it."""
    global _built_int8, _tile, _max_leaves, _max_lg_tr
    if _built_int8 is None:
        built = build(SOURCE_INT8)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = built.lib.adamw_int8_many
        fn.argtypes = [ptr] + [i32] * 3 + [ptr] * 3 + [ctypes.c_float] * 6 + [ptr]
        fn.restype = i32
        for name in ("adamw_int8_leaf_bytes", "adamw_int8_max_leaves", "adamw_int8_tile",
                     "adamw_int8_max_lg_tr"):
            getattr(built.lib, name).restype = i32
        if built.lib.adamw_int8_leaf_bytes() != ctypes.sizeof(_Leaf):
            raise RuntimeError("adamw_int8: the C and ctypes leaf tables differ")
        _tile, _max_leaves = built.lib.adamw_int8_tile(), built.lib.adamw_int8_max_leaves()
        _max_lg_tr = built.lib.adamw_int8_max_lg_tr()
        _built_int8 = built
    return _built_int8


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_INT8
    LAUNCHES = LAUNCHES_INT8 = 0


def fused_adamw_bf16_plain(p, g, mu, nu, scalars, *, b1: float, b2: float,
                           eps: float, wd: float) -> None:
    """The kernel's function in plain PyTorch (fp32 math, in place)."""
    coef, lr, c1, c2 = scalars.unbind()
    g = g.reshape(p.shape) * coef
    m = b1 * mu.reshape(p.shape).float() + (1.0 - b1) * g
    v = b2 * nu.reshape(p.shape).float() + (1.0 - b2) * g * g
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    p.copy_(p - lr * (u + wd * p))
    mu.copy_(m.reshape(mu.shape))
    nu.copy_(v.reshape(nu.shape))


def _check(p, g, mu, nu, scalars) -> None:
    devs = {t.device for t in (p, g, mu, nu, scalars)}
    if len(devs) != 1 or p.device.type != "cuda":
        raise ValueError(f"fused_adamw_bf16: tensors must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    want = ((p, torch.float32, "p"), (g, torch.float32, "g"), (mu, torch.bfloat16, "mu"),
            (nu, torch.bfloat16, "nu"), (scalars, torch.float32, "scalars"))
    for t, dtype, name in want:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_adamw_bf16: {name} must be contiguous {dtype}, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
    n = p.numel()
    if not (g.numel() == mu.numel() == nu.numel() == n) or scalars.numel() != 4:
        raise ValueError(f"fused_adamw_bf16: sizes p {n}, g {g.numel()}, mu "
                         f"{mu.numel()}, nu {nu.numel()}, scalars {scalars.numel()}")


def fused_adamw_bf16(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                     b2: float, eps: float, wd: float) -> None:
    """One fused AdamW step for one leaf, in place (p, mu, nu)."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (p, g, mu, nu, scalars)):
        fused_adamw_bf16_plain(p, g, mu, nu, scalars, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    _check(p, g, mu, nu, scalars)
    fn = load().lib.adamw_bf16
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                 scalars.data_ptr(), p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
                 wd, stream)
    if err != 0:
        raise RuntimeError(f"adamw_bf16 launch failed: cudaError_t {err}")
    LAUNCHES += 1


def fused_adamw_int8_plain(p, g, mu_q, mu_s, nu_q, nu_s, scalars, *, b1: float,
                           b2: float, eps: float, wd: float) -> None:
    """K4's function in plain PyTorch (fp32 math, in place), with the TPU
    kernel's rounding points. p and g are the leaf's JAX-layout views: their
    row-major flatten, cut into rows of QBLOCK, gives the kernel's blocks."""
    C = mu_q.shape[0]
    # divisors as tensors: torch on a card divides by a Python number through
    # its reciprocal, which rounds differently from the kernel's division
    k, c127 = (torch.tensor(x, dtype=torch.float32, device=p.device)
               for x in (NU_LOG_RANGE / 126.0, 127.0))
    coef, lr, c1, c2 = scalars.unbind()
    g = g.reshape(C, QBLOCK) * coef
    mu = mu_q.float() * mu_s
    nc = nu_q.float()
    nu = torch.where(nc > 0.0, nu_s * torch.exp((nc - 127.0) * k), 0.0)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p32 = p.reshape(C, QBLOCK)
    p.copy_((p32 - lr * (u + wd * p32)).reshape(p.shape))
    ms = torch.clamp(mu.abs().amax(dim=1, keepdim=True), min=1e-10) / c127
    mu_q.copy_(torch.round(mu / ms).to(torch.int8))
    mu_s.copy_(ms)
    ss = torch.clamp(nu.amax(dim=1, keepdim=True), min=1e-30)
    logc = 127.0 + torch.log(torch.clamp(nu, min=1e-38) / ss) / k
    nu_q.copy_(torch.clamp(torch.round(logc), 1.0, 127.0).to(torch.int8))
    nu_s.copy_(ss)




def _strides(t: torch.Tensor) -> list[int]:
    """The strides that address anything: those of dims longer than 1 (a
    size-1 dim's stride is arbitrary, e.g. in a gradient of a 1x1 conv)."""
    return [st for st, n in zip(t.stride(), t.shape) if n > 1]


def int8_layout(view: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, O, R, KK) of a leaf's JAX-layout view, as K4 addresses it
    (csrc/adamw_int8.cu's header): torch offset (b, o, r) = (b * O + o) * R
    + r and JAX index (b * R + (r % KK) * (R / KK) + r // KK) * O + o. The
    view must be a permutation of a dense block whose last dim (O) is
    followed in memory by the dims R spans and preceded by those B spans,
    these in memory order and those in memory order rotated (a Linear
    weight's (1, 0), a conv's (2, 3, 1, 0), a transposed conv's (0, 2, 3,
    1), the identity). Raises ValueError for any other view."""
    dims = [(n, st) for n, st in zip(view.shape, view.stride()) if n > 1]
    if not dims:
        return 1, 1, 1, 1
    mem = sorted(range(len(dims)), key=lambda d: -dims[d][1])  # outermost first
    dense = 1
    for d in reversed(mem):
        if dims[d][1] != dense:
            raise ValueError(f"K4: the view {tuple(view.shape)}/{view.stride()} is not "
                             "a permutation of a dense block")
        dense *= dims[d][0]
    O, so = dims[-1]
    head = range(len(dims) - 1)
    outer = [d for d in head if dims[d][1] > so]
    inner = [d for d in head if dims[d][1] < so]
    inner_mem = [d for d in mem if dims[d][1] < so]

    def size(ds):
        return math.prod(dims[d][0] for d in ds)

    if list(head) == outer + inner and outer == [d for d in mem if dims[d][1] > so]:
        if not inner:  # o contiguous too: one run
            return 1, size(outer) * O, 1, 1
        for k in range(len(inner_mem), -1, -1):  # KK = 1 first
            if inner == inner_mem[k:] + inner_mem[:k]:
                return size(outer), O, size(inner), size(inner_mem[k:])
    raise ValueError(f"K4 cannot take the layout of the view {tuple(view.shape)}/"
                     f"{view.stride()}")


class _Leaf(ctypes.Structure):
    """One entry of K4's leaf table (``Leaf`` in csrc/adamw_int8.cu)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("p", "g", "mu_q", "mu_s", "nu_q",
                                                       "nu_s")]
                + [(name, ctypes.c_int) for name in ("O", "R", "KK", "lg_tr", "tiles_r",
                                                     "tiles_b", "tile0", "row0", "rows")]
                + [("wd", ctypes.c_float)])


def _check_leaf(p, mu_q, mu_s, nu_q, nu_s) -> _Leaf:
    """K4's table entry of one CUDA leaf (no gradient, no offsets yet), or
    ValueError for what the kernel does not take."""
    ts = (p, mu_q, mu_s, nu_q, nu_s)
    devs = {t.device for t in ts}
    if len(devs) != 1 or p.device.type != "cuda":
        raise ValueError(f"fused_adamw_int8: tensors must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    want = ((p, torch.float32, "p"), (mu_q, torch.int8, "mu_q"), (mu_s, torch.float32, "mu_s"),
            (nu_q, torch.int8, "nu_q"), (nu_s, torch.float32, "nu_s"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise ValueError(f"fused_adamw_int8: {name} must be {dtype}, got {t.dtype}")
    for t, name in ((mu_q, "mu_q"), (mu_s, "mu_s"), (nu_q, "nu_q"), (nu_s, "nu_s")):
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw_int8: {name} must be contiguous")
    C = mu_q.shape[0] if mu_q.dim() == 2 else -1
    if (mu_q.shape != (C, QBLOCK) or nu_q.shape != (C, QBLOCK) or mu_s.numel() != C
            or nu_s.numel() != C):
        raise ValueError(f"fused_adamw_int8: want codes [C, {QBLOCK}] and scales of C "
                         f"elements, got {tuple(mu_q.shape)}, {tuple(nu_q.shape)}, "
                         f"{tuple(mu_s.shape)}, {tuple(nu_s.shape)}")
    if p.numel() != C * QBLOCK or p.numel() >= 2 ** 31:
        raise ValueError(f"fused_adamw_int8: p has {p.numel()} elements, want "
                         f"{C} x {QBLOCK} < 2^31")
    _, O, R, KK = int8_layout(p)
    load_int8()
    if mu_q.data_ptr() % 4 or nu_q.data_ptr() % 4:
        raise ValueError("fused_adamw_int8: the codes must start on 4-byte boundaries")
    # the tile's extent along r: the library's largest, or down to 8 for a
    # shorter run, 1 for none
    lg_tr = 0 if R == 1 else min(_max_lg_tr, max(3, (R - 1).bit_length()))
    TR, TO = 1 << lg_tr, _tile >> lg_tr
    tiles_r = -(-R // TR)
    return _Leaf(p=p.data_ptr(), mu_q=mu_q.data_ptr(), mu_s=mu_s.data_ptr(),
                 nu_q=nu_q.data_ptr(), nu_s=nu_s.data_ptr(), O=O, R=R, KK=KK, lg_tr=lg_tr,
                 tiles_r=tiles_r, tiles_b=-(-O // TO) * tiles_r, rows=C)


class Int8Table:
    """K4 over a fixed list of leaves, each ``(p, mu_q, mu_s, nu_q, nu_s,
    wd)`` with p the leaf's JAX-layout view: built once (checks, layouts,
    tiles, state pointers, and for CUDA leaves a per-row scratch that every
    call leaves at 0, unless the caller lends one). ``step(grads, scalars)``
    updates in place the leaves whose gradient is not None; a gradient is a
    view of its p's shape and strides. CPU leaves go to
    ``fused_adamw_int8_plain``, one leaf at a time; CUDA leaves go to the
    kernel (INT8_PASSES launches per chunk of at most ``max_leaves``) or
    raise."""

    def __init__(self, leaves, *, b1: float, b2: float, eps: float,
                 scratch: torch.Tensor | None = None):
        self.leaves = [tuple(leaf) for leaf in leaves]
        self.hp = dict(b1=b1, b2=b2, eps=eps)
        self.plain = all(t.device.type == "cpu" for leaf in self.leaves for t in leaf[:5])
        self._plans: dict[tuple[int, ...], list] = {}
        if self.plain:
            return
        self.entries = []
        for p, mu_q, mu_s, nu_q, nu_s, wd in self.leaves:
            entry = _check_leaf(p, mu_q, mu_s, nu_q, nu_s)
            entry.wd = wd
            self.entries.append(entry)
        dev = self.leaves[0][0].device
        if any(leaf[0].device != dev for leaf in self.leaves):
            raise ValueError("fused_adamw_int8: leaves on more than one device")
        # the scratch: each row's max |m| and max v as fp32 bits
        rows = sum(e.rows for e in self.entries)
        if scratch is None:
            scratch = torch.zeros(2 * rows, dtype=torch.int32, device=dev)
        elif (scratch.numel() < 2 * rows or scratch.device != dev
              or scratch.dtype != torch.int32 or not scratch.is_contiguous()):
            raise ValueError(f"fused_adamw_int8: want a contiguous int32 scratch of at "
                             f"least {2 * rows} elements")
        self.scratch = scratch
        self._ptrs = (scratch.data_ptr(), scratch.data_ptr() + 4 * rows)

    def _plan(self, live: tuple[int, ...]) -> list:
        """The launches of one live set: per chunk of at most max_leaves
        leaves, its table (tile0/row0 from 0) and its scratch rows."""
        if live not in self._plans:
            chunks, row_base = [], 0
            for c in range(0, len(live), _max_leaves):
                idx = live[c:c + _max_leaves]
                table = (_Leaf * len(idx))()
                tiles = rows = 0
                for j, i in enumerate(idx):
                    e = self.entries[i]
                    table[j] = e
                    table[j].tile0, table[j].row0 = tiles, rows
                    tiles += e.rows * QBLOCK // (e.O * e.R) * e.tiles_b
                    rows += e.rows
                chunks.append((idx, table, tiles, rows, row_base))
                row_base += rows
            self._plans[live] = chunks
        return self._plans[live]

    def step(self, grads, scalars: torch.Tensor) -> None:
        global LAUNCHES_INT8
        if len(grads) != len(self.leaves):
            raise ValueError(f"fused_adamw_int8: {len(grads)} gradients for "
                             f"{len(self.leaves)} leaves")
        live = tuple(i for i, g in enumerate(grads) if g is not None)
        if self.plain and all(grads[i].device.type == "cpu" for i in live) \
                and scalars.device.type == "cpu":
            for i in live:
                p, mu_q, mu_s, nu_q, nu_s, wd = self.leaves[i]
                fused_adamw_int8_plain(p, grads[i], mu_q, mu_s, nu_q, nu_s, scalars,
                                       wd=wd, **self.hp)
            return
        if self.plain:
            raise ValueError("fused_adamw_int8: CPU leaves with CUDA tensors")
        dev = self.scratch.device
        if (scalars.device != dev or scalars.dtype != torch.float32 or scalars.numel() != 4
                or not scalars.is_contiguous()):
            raise ValueError(f"fused_adamw_int8: scalars must be 4 contiguous fp32 on {dev}")
        for i in live:
            g, p = grads[i], self.leaves[i][0]
            if (g.device != dev or g.dtype != torch.float32 or g.shape != p.shape
                    or _strides(g) != _strides(p)):
                raise ValueError(f"fused_adamw_int8: gradient {i} must be an fp32 view of "
                                 f"p's shape and strides on {dev}, got {tuple(g.shape)}/"
                                 f"{g.stride()} {g.dtype} on {g.device} for p "
                                 f"{tuple(p.shape)}/{p.stride()}")
        if not live:
            return
        fn = load_int8().lib.adamw_int8_many
        b1, b2 = self.hp["b1"], self.hp["b2"]
        amax, nmax = self._ptrs
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for idx, table, tiles, rows, row_base in self._plan(live):
                for j, i in enumerate(idx):
                    table[j].g = grads[i].data_ptr()
                err = fn(table, len(idx), tiles, rows, amax + 4 * row_base, nmax + 4 * row_base,
                         scalars.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, self.hp["eps"],
                         NU_LOG_RANGE / 126.0, stream)
                if err != 0:
                    raise RuntimeError(f"adamw_int8 launch failed: cudaError_t {err}")
                LAUNCHES_INT8 += INT8_PASSES


def int8_launches(n_leaves: int) -> int:
    """K4's launches in one CUDA step over n_leaves leaves with a gradient."""
    load_int8()
    return INT8_PASSES * -(-n_leaves // _max_leaves)


_one_off_scratch: dict[torch.device, torch.Tensor] = {}


def _scratch_for(leaves) -> torch.Tensor | None:
    """A zero scratch for a one-off CUDA call, kept per device and reused
    (every call leaves it at 0; calls on one stream at a time)."""
    p = leaves[0][0]
    if p.device.type != "cuda":
        return None
    size = 2 * sum(leaf[1].shape[0] for leaf in leaves)
    have = _one_off_scratch.get(p.device)
    if have is None or have.numel() < size:
        have = _one_off_scratch[p.device] = torch.zeros(size, dtype=torch.int32,
                                                        device=p.device)
    return have


def fused_adamw_int8_many(leaves, scalars: torch.Tensor, *, b1: float, b2: float,
                          eps: float) -> None:
    """One fused int8-moment AdamW step for several leaves, in place: each
    leaf is ``(p, g, mu_q, mu_s, nu_q, nu_s, wd)`` as ``fused_adamw_int8``
    takes it, g None for a leaf left out. CPU tensors go to the plain
    version leaf by leaf; CUDA leaves go to K4, INT8_PASSES launches for
    up to max_leaves leaves, or raise."""
    leaves = [tuple(leaf) for leaf in leaves]
    static = [(p, *state, wd) for p, _, *state, wd in leaves]
    Int8Table(static, b1=b1, b2=b2, eps=eps, scratch=_scratch_for(static)).step(
        [leaf[1] for leaf in leaves], scalars)


def fused_adamw_int8(p: torch.Tensor, g: torch.Tensor, mu_q: torch.Tensor,
                     mu_s: torch.Tensor, nu_q: torch.Tensor, nu_s: torch.Tensor,
                     scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                     wd: float) -> None:
    """One fused int8-moment AdamW step for one leaf, in place (p, codes,
    scales)."""
    fused_adamw_int8_many([(p, g, mu_q, mu_s, nu_q, nu_s, wd)], scalars, b1=b1, b2=b2,
                          eps=eps)
