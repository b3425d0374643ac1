"""The gate-window kernels' design (``repro_torch/kernels/csrc/gate_window.cu``).

On the CPU:
  * a numpy model of the kernels' byte-word arithmetic -- a run of 16 workers
    as four 32-bit words of 0/1 bytes, rows padded to the kernel's row bucket,
    bytewise OR, sum and AND, dp4a row counts, the first/last-row pair test the
    kernels use and the suffix-OR rule it stands for -- held exactly against the
    plain versions (``kernels/gate_window/ref.py``) and the JAX package's
    statistics, with hypothesis over 0-32 rows (every bucket edge), n from 1 to
    300 and B from 1 to rows + 1;
  * which views the wrappers send down the kernels' wide path (16-byte loads):
    the gate's contiguous buffers, their tails at every fill and the windows it
    concatenates do; a misaligned row start and a stride-2 worker axis do not.
On the card (``-m cuda``, skipped without one): both kernels exact against the
plain versions on both paths, at every row bucket's edges, at (4096, 3, 256) and
past one wave of blocks, with the launches each path counts.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.gate_window import gate_window as gw_kernel
from repro_torch.kernels.gate_window import ops as gw_ops
from repro_torch.kernels.gate_window import ref as gw_ref

ONES = np.uint32(0x01010101)
RUN = 16                                     # workers a lane owns
BUCKETS = (4, 8, 16, 32)                     # the kernels' row templates
EDGES = (0, 1, 4, 5, 8, 9, 16, 17, 32)       # every bucket's edges


# -- the numpy model of the kernels' arithmetic --------------------------------


def _bucket(rows):
    return next(b for b in BUCKETS if rows <= b)


def _words(x: np.ndarray) -> np.ndarray:
    """bool (cells, rows, n) -> uint32 (cells, R, runs, 4): a run of 16 workers
    as four little-endian words of 0/1 bytes, zero past n and past ``rows`` up
    to the row bucket R, as a lane holds them."""
    cells, rows, n = x.shape
    runs = -(-n // RUN)
    b = np.zeros((cells, _bucket(rows), runs * RUN), np.uint8)
    b[:, :rows, :n] = x
    return _nonzero_bytes(b.view("<u4").reshape(cells, -1, runs, 4))


def _bytes(w: np.ndarray) -> np.ndarray:
    """uint32 (..., 4) words -> their 16 bytes (..., 16), worker order."""
    return np.ascontiguousarray(w.astype("<u4")).view(np.uint8).reshape(w.shape[:-1] + (16,))


def _nonzero_bytes(w):
    return ((((w & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | w) >> 7) & ONES


def _dp4a(w):
    """dp4a(w, 0x01010101, 0) of each word: the sum of its bytes."""
    return np.ascontiguousarray(w.astype("<u4")).view(np.uint8).reshape(w.shape + (4,)).sum(
        axis=-1, dtype=np.int64)


def _max_byte(w):
    return _bytes(w).max(axis=-1)


def _run_stats(v, d, pairs):
    """OR, bytewise sum and the pair bits of every run over the rows, unrolled
    as the kernels do: (cells, runs, 4) each."""
    R = v.shape[1]
    any_ = np.zeros_like(v[:, 0])
    sum_, first, last = any_.copy(), any_.copy(), any_.copy()
    for r in range(R):
        m = v[:, r] * np.uint32(0xFF)
        any_ |= v[:, r]
        sum_ += v[:, r]
        last = (last & ~m) | (m & np.uint32(r * ONES))
        q = R - 1 - r
        mq = v[:, q] * np.uint32(0xFF)
        first = (first & ~mq) | (mq & np.uint32(q * ONES))
    pair = np.zeros_like(any_)
    if pairs:
        pair = (last - first + np.uint32((128 - d) * ONES)) & np.uint32(0x80808080)
    return any_, sum_, pair


def _pair_suffix_or(v, rows, d):
    """The suffix-OR rule: a worker straggles in row r and in some row >= r + d."""
    bad = np.zeros(v.shape[0], bool)
    for r in range(rows - d):
        suffix = np.bitwise_or.reduce(v[:, r + d:rows], axis=1)
        bad |= (v[:, r] & suffix).any(axis=(1, 2))
    return bad


def model_window_stats(x: np.ndarray, B: int):
    rows = x.shape[1]
    v, d = _words(x), max(B, 1)
    any_, sum_, pair = _run_stats(v, d, d < rows)
    rc = [_dp4a(v[:, r]).sum(axis=(1, 2)) for r in range(rows)]
    round_max = np.max(rc, axis=0) if rows else np.zeros(x.shape[0], np.int64)
    return (_dp4a(any_).sum(axis=(1, 2)), _max_byte(sum_).max(axis=1), round_max,
            (pair != 0).any(axis=(1, 2)))


def model_buffer_stats(x: np.ndarray, B: int):
    cells, rows, n = x.shape
    v, d = _words(x), max(B, 1)
    any_, sum_, pair = _run_stats(v, d, d < rows)
    md = np.zeros_like(any_)
    for r in range(v.shape[1]):
        if r <= rows - B:
            md |= v[:, r]

    def per_worker(w):
        return _bytes(w).reshape(cells, -1)[:, :n]

    return (per_worker(any_) != 0, per_worker(sum_).astype(np.int32), per_worker(md) != 0,
            (pair != 0).any(axis=(1, 2)))


@st.composite
def _windows(draw):
    rows = draw(st.one_of(st.sampled_from(EDGES), st.integers(0, 32)))
    n = draw(st.one_of(st.sampled_from((1, 15, 16, 17, 33, 130, 256, 300)),
                       st.integers(1, 300)))
    cells = draw(st.integers(1, 3))
    B = draw(st.integers(1, rows + 1))
    p = draw(st.sampled_from((0.02, 0.2, 0.6)))
    seed = draw(st.integers(0, 2**32 - 1))
    return np.random.default_rng(seed).random((cells, rows, n)) < p, B


def _assert_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@settings(max_examples=150, deadline=None)
@given(_windows())
def test_model_window_stats_matches_plain_and_jax(case):
    from repro.core.straggler import _window_stats

    x, B = case
    got = model_window_stats(x, B)
    _assert_equal(got, [t.numpy() for t in gw_ref.window_stats(torch.from_numpy(x), B)])
    _assert_equal(got, _window_stats(x, B))
    if x.shape[1]:
        np.testing.assert_array_equal(got[3], _pair_suffix_or(_words(x), x.shape[1], max(B, 1)))


@settings(max_examples=150, deadline=None)
@given(_windows())
def test_model_buffer_stats_matches_plain_and_jax(case):
    from repro.core.straggler import _buffer_stats

    x, B = case
    got = model_buffer_stats(x, B)
    _assert_equal(got, [t.numpy() for t in gw_ref.buffer_stats(torch.from_numpy(x), B)])
    _assert_equal(got, _buffer_stats(x, B))


@pytest.mark.parametrize("B", [1, 2, 3])
def test_model_pair_rules_agree_at_every_row_count(B):
    """The first/last-row pair test and the suffix-OR rule, against the plain
    version, at every row count and a dense enough window to have pairs."""
    rng = np.random.default_rng(B)
    for rows in range(33):
        x = rng.random((8, rows, 40)) < 0.04
        want = gw_ref.window_stats(torch.from_numpy(x), B)[3].numpy()
        np.testing.assert_array_equal(model_window_stats(x, B)[3], want)
        np.testing.assert_array_equal(_pair_suffix_or(_words(x), rows, B), want)


def test_model_nonzero_bytes_marks_every_nonzero_byte():
    """The kernels' byte normalisation: 1 in each nonzero byte, 0 elsewhere."""
    b = np.arange(256, dtype=np.uint8)
    b = np.stack([b, np.roll(b, 1), np.roll(b, 7), np.roll(b, 100)], axis=1)
    w = np.ascontiguousarray(b).view("<u4")[:, 0]
    out = np.ascontiguousarray(_nonzero_bytes(w)).view(np.uint8).reshape(256, 4)
    np.testing.assert_array_equal(out, (b != 0).astype(np.uint8))


# -- which views take the wide path ----------------------------------------------


def _gate_views(device="cpu", cells=64, n=256, windows=(2, 3, 4, 11), seed=0):
    """The views the gate passes the kernels (``core/kernel.py GateKernel``):
    each window's tail ``buf[:, w-1-filled:]`` at every fill, and the window
    ``torch.cat([tail, cand[:, None]], dim=1)`` (``cand[:, None]`` when empty)."""
    rng = np.random.default_rng(seed)
    cand = torch.from_numpy(rng.random((cells, n)) < 0.3).to(device)
    for w in windows:
        buf = torch.from_numpy(rng.random((cells, w - 1, n)) < 0.3).to(device)
        for filled in range(w):
            tail = buf[:, w - 1 - min(filled, w - 1):]
            yield f"tail w {w} filled {filled}", tail
            win = torch.cat([tail, cand[:, None]], dim=1) if tail.shape[1] else cand[:, None]
            yield f"window w {w} filled {filled}", win


def test_gate_views_take_the_wide_path():
    for what, view in _gate_views():
        assert gw_kernel.wide_path(view), what


@pytest.mark.parametrize("what", ["row stride 260", "stride-2 workers", "n 130", "n 7",
                                  "misaligned start", "cell stride 8"])
def test_other_views_take_the_byte_path(what):
    big = torch.zeros(8, 4, 320, dtype=torch.bool)
    view = {
        "row stride 260": torch.zeros(8, 4, 260, dtype=torch.bool),
        "stride-2 workers": big[:, :, ::2],
        "n 130": torch.zeros(8, 3, 130, dtype=torch.bool),
        "n 7": torch.zeros(8, 3, 7, dtype=torch.bool),
        "misaligned start": big[:, :, 1:257],
        "cell stride 8": torch.zeros(16, 1, 8, dtype=torch.bool),
    }[what]
    assert gw_kernel.wide_path(big) and not gw_kernel.wide_path(view)


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_check(which, x, B, wide=None):
    """One launch of ``which`` on x, exact against the plain version, on the
    path ``wide`` says (either, for None)."""
    kernel = getattr(gw_kernel, which)
    before = (kernel.launches, kernel.wide_launches)
    took = gw_kernel.wide_path(x)
    assert wide is None or took == wide
    got = getattr(gw_ops, which)(x, B)
    assert (kernel.launches, kernel.wide_launches) == (before[0] + 1, before[1] + took)
    want = getattr(gw_ref, which)(x.cpu(), B)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.cuda
def test_gate_views_run_wide_on_the_card(cuda_device):
    for _, view in _gate_views(cuda_device):
        for B in (1, 2, view.shape[1] + 1):
            _card_check("buffer_stats", view, B, True)
            if view.shape[1]:
                _card_check("window_stats", view, B, True)


@pytest.mark.cuda
def test_byte_path_on_the_card(cuda_device):
    rng = np.random.default_rng(2)
    big = torch.from_numpy(rng.random((37, 5, 320)) < 0.3).to(cuda_device)
    views = [big[:, :, 1:257], big[:, :, ::2], big[:, 1:4, :130].contiguous(),
             big[:, :, :260].contiguous(), big[:, :3, 3:10]]
    for view in views:
        for which in ("window_stats", "buffer_stats"):
            for B in (1, 2, 4):
                _card_check(which, view, B, False)
    # aligned rows, n not a multiple of 16: the last run is read byte by byte
    for which in ("window_stats", "buffer_stats"):
        _card_check(which, big[:, :, :250], 2, True)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", EDGES)
def test_row_bucket_edges_on_the_card(cuda_device, rows):
    rng = np.random.default_rng(100 + rows)
    for cells, n in ((64, 256), (5, 130), (3, 33)):
        x = torch.from_numpy(rng.random((cells, rows, n)) < 0.2).to(cuda_device)
        wide = n % 16 == 0 if rows else None  # an empty window reads nothing
        for B in sorted({1, 2, max(rows - 1, 1), rows + 1}):
            _card_check("buffer_stats", x, B, wide)
            if rows:
                _card_check("window_stats", x, B, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [4096, 5000])
def test_large_grid_on_the_card(cuda_device, cells):
    """(4096, 3, 256), where the bytes begin to count, and more cells than the
    one wave of blocks the grid holds (132 x 32), which the grid-stride loop takes."""
    x = torch.from_numpy(np.random.default_rng(cells).random((cells, 3, 256)) < 0.05)
    x = x.to(cuda_device)
    for B in (1, 2, 4):
        for which in ("window_stats", "buffer_stats"):
            _card_check(which, x, B, True)
