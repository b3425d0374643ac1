"""Wrappers of the CUDA SSD chunk-scan kernels (``csrc/ssd_scan.cu``,
``csrc/ssd_scan_bwd.cu``).

``ssd_intra_chunk`` replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::_intra_kernel``,
forward only, as the JAX package has it: y_intra in f32.  ``ssd_chunk_scan``
is the same kernel with the chunk's output in its epilogue: the inter-chunk
term, the D skip and the cast that ``models/ssm.py`` otherwise runs as torch
passes.  ``ssd_chunk_scan_bwd`` is its backward, which the JAX package does
not have (it trains through its jnp path).  The sources' headers say what
bounds them and how the designs answer that.

bf16 runs on the tensor cores, f32 on the CUDA cores (and so does the
backward of bf16 inputs with an f32 dy).  The bf16 kernels copy rows of x, B
and C (and the backward's dy) 16 bytes at a time where their lengths
(head_dim, d_state) are multiples of 8 elements; such a tensor must then have
a contiguous last dim and 16-byte aligned rows, and the wrappers raise
otherwise rather than copy it.  Rows of other lengths are read element by
element.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_CHUNK = 128       # Q, the rows of a chunk
MAX_HEAD_DIM = 128
MAX_STATE = 512
#: state columns of a block of the backward's inter-chunk launch: the CUDA-core
#: kernels' (ssd_scan_bwd.cu kStTile), and the tensor-core kernels' at Q <= 64
#: and d_state > 64 (8 warps of 16 columns; else 8 of 8, as BWD_STATE_TILE)
BWD_STATE_TILE = 64
BWD_STATE_TILE_WIDE = 128
#: blocks the backward aims at for each SM: it splits the heads into groups
#: until each of its two per-head launches has at least this many a SM
BWD_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _intra_fn():
    fn = _build.library().ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scan_fn():
    fn = _build.library().ssd_chunk_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = _build.library().ssd_chunk_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vec_rows(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, what: str) -> bool:
    """Whether the bf16 kernel copies x, B and C rows 16 bytes at a time: yes
    for row lengths that are multiples of 8 elements, whose views must then be
    16-byte aligned (raises otherwise); no for other lengths."""
    if x.dtype != torch.bfloat16 or x.shape[3] % 8 or B.shape[2] % 8:
        return False
    for name, t in (("x", x), ("B", B), ("C", C)):
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                n > 1 and (st * size) % 16 for n, st in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"{what}: the bf16 kernel copies 16-byte rows, but {name} has data "
                             f"pointer {t.data_ptr()} and strides {t.stride()} (elements)")
    return True


def _check(x, dt, cum, B, C, what) -> None:
    ts = {"x": x, "dt": dt, "cum": cum, "B": B, "C": C}
    if any(t.device.type != "cuda" or t.device != x.device for t in ts.values()):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in ts.items()))
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"{what} kernel takes x (bc, Q, nh, hd) and B, C (bc, Q, st), "
                         f"got {tuple(x.shape)} and {tuple(B.shape)}")
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    if dt.shape != (bc, Q, nh) or cum.shape != (bc, Q, nh) or C.shape != (bc, Q, st):
        raise ValueError(f"{what} kernel: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}")
    if x.dtype not in _build.DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{what} kernel takes x, B, C all float32 or all bfloat16, "
                         f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise ValueError(f"{what} kernel takes dt and cum in float32, got "
                         f"{dt.dtype}, {cum.dtype}")
    if Q > MAX_CHUNK or hd > MAX_HEAD_DIM or st > MAX_STATE:
        raise ValueError(f"{what} kernel takes Q <= {MAX_CHUNK}, head_dim <= "
                         f"{MAX_HEAD_DIM} and d_state <= {MAX_STATE}, got Q {Q}, head_dim "
                         f"{hd}, d_state {st}")


def _check_chunks(x, dt, cum, B, C, h_prev, D, nc, s, what) -> None:
    """:func:`_check`, and the fused entry's sequences, h_prev and D."""
    _check(x, dt, cum, B, C, what)
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    if nc < 1 or bc % nc or not (nc - 1) * Q < s <= nc * Q:
        raise ValueError(f"{what}: {bc} batch-chunks of Q {Q} are not b sequences of "
                         f"{nc} chunks holding s {s} rows")
    if h_prev.shape != (bc, nh, hd, st) or h_prev.dtype != torch.float32 \
            or not h_prev.is_contiguous() or h_prev.device != x.device:
        raise ValueError(f"{what}: h_prev must be contiguous f32 {(bc, nh, hd, st)} on "
                         f"{x.device}, got {tuple(h_prev.shape)} {h_prev.dtype} strides "
                         f"{h_prev.stride()}")
    if D.shape != (nh,) or D.dtype != torch.float32 or D.stride(0) != 1 or D.device != x.device:
        raise ValueError(f"{what}: D must be contiguous f32 ({nh},) on {x.device}, got "
                         f"{tuple(D.shape)} {D.dtype}")


def _strides(x, dt, cum, B, C):
    return (ctypes.c_longlong * 16)(*x.stride(), *dt.stride(), *cum.stride(), *B.stride(),
                                    *C.stride())


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD output y (bc, Q, nh, hd), f32, on CUDA tensors.

    x (bc, Q, nh, hd) and B, C (bc, Q, st) all f32 or all bf16; dt, cum
    (bc, Q, nh) f32.  Strided views: the kernel reads through the strides
    (bf16: see the module's note on 16-byte rows).
    """
    _check(x, dt, cum, B, C, "ssd_intra_chunk")
    vec = _vec_rows(x, B, C, "ssd_intra_chunk")
    bc, Q, nh, hd = x.shape
    y = torch.empty((bc, Q, nh, hd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    code = _intra_fn()(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        bc, Q, nh, hd, B.shape[2], _strides(x, dt, cum, B, C), _build.DTYPE_CODES[x.dtype],
        int(vec), x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "ssd_intra_chunk")
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, h_prev: torch.Tensor, D: torch.Tensor, nc: int, s: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The chunked SSD output y (b, s, nh, hd) in ``out_dtype``, on CUDA tensors.

    x, dt, cum, B, C as for :func:`ssd_intra_chunk`, over bc = b * nc
    batch-chunks (chunk c of sequence i at bc = i * nc + c); h_prev (bc, nh,
    hd, st) f32 contiguous, the state entering each chunk; D (nh,) f32.
    y[i, c * Q + q] = y_intra + exp(cum) C . h_prev + D x, summed in f32 and
    rounded once; rows past ``s`` are dropped.  ``out_dtype`` is float32 or
    the inputs' dtype.
    """
    _check_chunks(x, dt, cum, B, C, h_prev, D, nc, s, "ssd_chunk_scan")
    vec = _vec_rows(x, B, C, "ssd_chunk_scan")
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    if out_dtype not in (torch.float32, x.dtype):
        raise ValueError(f"ssd_chunk_scan: out_dtype must be float32 or the inputs' {x.dtype}, "
                         f"got {out_dtype}")
    y = torch.empty((bc // nc, s, nh, hd), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    code = _scan_fn()(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        h_prev.data_ptr(), D.data_ptr(), y.data_ptr(), bc, nc, s, Q, nh, hd, st,
        _strides(x, dt, cum, B, C), _build.DTYPE_CODES[x.dtype], int(vec),
        _build.DTYPE_CODES[out_dtype], x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "ssd_chunk_scan")
    ssd_chunk_scan.launches += 1
    return y


ssd_chunk_scan.launches = 0


def bwd_state_tile(Q: int, st: int, tensor_cores: bool) -> int:
    """State columns of a block of the backward's inter launch."""
    return BWD_STATE_TILE_WIDE if tensor_cores and Q <= 64 and st > 64 else BWD_STATE_TILE


def bwd_plan(bc: int, Q: int, nh: int, st: int, sms: int,
             tensor_cores: bool) -> tuple[int, int, int, int, int]:
    """The backward's launch plan: (state tiles of an inter block, inter
    groups, heads a group, intra groups, heads a group).  Each per-head launch
    (inter: bc x state tiles blocks; intra: bc) splits its heads into the
    fewest groups that give it ``BWD_BLOCKS_PER_SM`` blocks a SM, and no
    empty group.  ``tensor_cores``: the bf16 kernels (bf16 inputs and dy)."""

    def groups(blocks):
        g = min(nh, max(1, -(-BWD_BLOCKS_PER_SM * sms // blocks)))
        per = -(-nh // g)
        return -(-nh // per), per

    tiles = -(-st // bwd_state_tile(Q, st, tensor_cores))
    return (tiles, *groups(bc * tiles), *groups(bc))


def bwd_workspace(bc: int, Q: int, nh: int, st: int, tiles: int, g_inter: int,
                  g_intra: int) -> int:
    """f32 elements of the backward's workspace (``csrc/ssd_scan_bwd.cu``):
    dcum's inter part per state tile, dC's per inter group, dS per intra
    group, dD per batch-chunk."""
    return bc * tiles * Q * nh + g_inter * bc * Q * st + g_intra * bc * Q * Q + bc * nh


def ssd_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, h_prev: torch.Tensor, D: torch.Tensor, dy: torch.Tensor,
                       nc: int, s: int) -> tuple[torch.Tensor, ...]:
    """Gradients of :func:`ssd_chunk_scan` for dy (b, s, nh, hd), on CUDA tensors:
    (dx, ddt, dcum, dB, dC, dh_prev, dD), contiguous, in the inputs' layout;
    dx, dB and dC in the inputs' dtype, the rest f32 (the formulas are
    ``ref.ssd_chunk_scan_bwd``'s).  Inputs as for :func:`ssd_chunk_scan`
    (x, B and C read through their strides; bf16: see the module's note on
    16-byte rows, which binds dy too); dy contiguous, in float32 or the
    inputs' dtype.  bf16 inputs and dy run on the tensor cores, anything else
    on the CUDA cores.  Deterministic: two calls give the same bits.
    """
    _check_chunks(x, dt, cum, B, C, h_prev, D, nc, s, "ssd_chunk_scan_bwd")
    bc, Q, nh, hd = x.shape
    st = B.shape[2]
    if dy.shape != (bc // nc, s, nh, hd) or dy.dtype not in (torch.float32, x.dtype) \
            or not dy.is_contiguous() or dy.device != x.device:
        raise ValueError(f"ssd_chunk_scan_bwd: dy must be contiguous {(bc // nc, s, nh, hd)} in "
                         f"float32 or {x.dtype} on {x.device}, got {tuple(dy.shape)} {dy.dtype} "
                         f"strides {dy.stride()}")

    def out(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    grads = (out((bc, Q, nh, hd), x.dtype), out((bc, Q, nh)), out((bc, Q, nh)),
             out((bc, Q, st), x.dtype), out((bc, Q, st), x.dtype), out((bc, nh, hd, st)),
             out((nh,)))
    tensor_cores = x.dtype == dy.dtype == torch.bfloat16
    vec = tensor_cores and _vec_rows(x, B, C, "ssd_chunk_scan_bwd")
    for name, t, copied in (("dy", dy, vec), ("h_prev", h_prev, tensor_cores and st % 4 == 0)):
        if copied and t.data_ptr() % 16:
            raise ValueError(f"ssd_chunk_scan_bwd: the bf16 kernels copy 16-byte rows, but {name} "
                             f"has data pointer {t.data_ptr()}")
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    plan = bwd_plan(bc, Q, nh, st, _build.sm_count(x.device), tensor_cores)
    ws = out((bwd_workspace(bc, Q, nh, st, plan[0], plan[1], plan[3]),))
    code = _bwd_fn()(
        x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
        h_prev.data_ptr(), D.data_ptr(), dy.data_ptr(), *(g.data_ptr() for g in grads),
        ws.data_ptr(), bc, nc, s, Q, nh, hd, st, _strides(x, dt, cum, B, C),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[dy.dtype], int(vec), *plan,
        x.device.index, _build.stream_handle(x),
    )
    _build.check(code, "ssd_chunk_scan_bwd")
    ssd_chunk_scan_bwd.launches += 1
    return grads


ssd_chunk_scan_bwd.launches = 0
