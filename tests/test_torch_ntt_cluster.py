"""The one-launch cluster NTT kernels' schedules, carried out in torch on the
CPU: the index arithmetic of ``fwd_cluster`` (K1 and K3 on u64 words, K4
and K6 on q32 words) and ``inv_cluster`` (K2, K5) in
tpu_fhe_torch/csrc/ntt.cu.

The model follows the kernels step by step, vectorised over the blocks of a
cluster and the threads of a block: chunking (C blocks of M words, shared
memory padded one word in 32), the cross-block stages on columns of C
values (BATCH columns per thread), the exchange (the forward pushes each
column value into its owner's chunk, the inverse pulls column slab r of
every peer's chunk), the local radix-8/4/2 passes with the kernels' twiddle
indices ((m + i) << s) + g and their Gentleman-Sande mirror, and the
epilogues, in the kernels' lazy ranges ([0, 4q) forward, [0, 2q) inverse).
Every case, at N = 2^10 .. 2^13 with C = 1, 2, 4, 8 blocks and a
non-identity limb_map, equals ``forward_ntt_plain`` / ``inverse_ntt_plain``
and, on one limb, the reference's golden transforms
(tpu_fhe/core/ntt_tables.py, plain Python), bit for bit.  No JAX program
runs here."""

import numpy as np
import pytest
import torch

from tpu_fhe.core.ntt_tables import (golden_forward_ntt, golden_inverse_ntt,
                                     make_ntt_tables as j_make_ntt_tables)

from tpu_fhe_torch.core.modulus import CoeffModulus
from tpu_fhe_torch.core.ntt_tables import make_ntt_tables
from tpu_fhe_torch.ops import modarith as ma, ntt
from tpu_fhe_torch.utils.convert import to_numpy

torch.set_num_threads(1)

KEY_BITS = {8: [60, 50, 60, 59], 4: [30, 29, 30, 30]}   # word bytes: key-level primes
VIEW = [3, 0, 2]                                         # a non-identity limb_map
BATCH_ROWS = 2


# -- the kernels' shapes and arithmetic ---------------------------------------

def pad32(e):
    return e + (e >> 5)


def cluster_shape(word: int, log_n: int, log_c: int | None = None) -> dict:
    """ClusterShape<W, LOG_N> (ntt.cu), a copy that changes with it: the
    card test ``test_cluster_shape_matches_cpu_model`` holds the kernel's
    block counts to the list ``test_kernel_shapes_default`` holds this copy
    to.  `log_c` overrides the number of blocks as a test of the schedule."""
    if log_c is None:
        log32k = 13 if word == 4 else 12
        log_c = (0 if log_n <= log32k else log_n - log32k if log_n <= log32k + 2
                 else log_n - log32k - 1)
        log_c = min(log_c, 3)
    log_m = log_n - log_c
    m = 1 << log_m
    threads = min(m // 8, 512)
    mc = m >> log_c
    return dict(log_c=log_c, c=1 << log_c, log_m=log_m, m=m, mc=mc, threads=threads,
                batch=2 if mc >= 2 * threads else 1, smem=(m + m // 32) * word)


def radix(left: int) -> int:
    """The passes' radix rule: R = 3, 2 or 1 with `left` stages to go."""
    return 1 if left == 1 else 2 if left in (2, 4) else 3


class Word:
    """The kernels' word arithmetic on int64 tensors: u64 words as their
    bit patterns (values below 2^63 here), u32 words as values in [0, 2^32)."""

    def __init__(self, bits: int):
        self.bits = bits

    def shoup_lazy(self, a, w, ws, q):
        """a w - floor(a ws / 2^bits) q mod 2^bits, in [0, 2q)."""
        if self.bits == 64:
            return ma.mul_mod_shoup_lazy(a, w, ws, q)
        hi = (a * (ws >> 16) + ((a * (ws & 0xFFFF)) >> 16)) >> 16
        return (a * w - hi * q) & ma.M32

    def fwd_bfly(self, x, y, w, ws, q):
        q2 = 2 * q
        a = torch.where(x >= q2, x - q2, x)
        t = self.shoup_lazy(y, w, ws, q)
        return a + t, a - t + q2

    def inv_bfly(self, x, y, w, ws, q):
        q2 = 2 * q
        u = x + y
        u = torch.where(u >= q2, u - q2, u)
        return u, self.shoup_lazy(x + q2 - y, w, ws, q)


def radix_fwd(word: Word, v: list, tw, r: int, m: int, i, q):
    """radix_fwd<W, R>: stage s pairs k, k + 2^(R-1-s) under twiddle
    ((m + i) << s) + g, g = k >> (R - s).  `tw(idx)` reads both tables."""
    for s in range(r):
        h = 1 << (r - 1 - s)
        for g in range(1 << s):
            w, ws = tw(((m + i) << s) + g)
            for kk in range(h):
                k = (g << (r - s)) + kk
                v[k], v[k + h] = word.fwd_bfly(v[k], v[k + h], w, ws, q)


def radix_inv(word: Word, v: list, tw, r: int, m: int, i, q):
    """radix_inv<W, R>: stage s pairs k, k + 2^s under twiddle
    ((m + i) << (R-1-s)) + g, g = k >> (s + 1)."""
    for s in range(r):
        h = 1 << s
        for g in range(1 << (r - 1 - s)):
            w, ws = tw(((m + i) << (r - 1 - s)) + g)
            for kk in range(h):
                k = (g << (s + 1)) + kk
                v[k], v[k + h] = word.inv_bfly(v[k], v[k + h], w, ws, q)


def _columns(sh: dict) -> torch.Tensor:
    """Block r's columns (C, M / C): r M / C + tid + it BATCH T + u T over
    its threads, iterations and batch, in the kernels' order."""
    t, b = sh["threads"], sh["batch"]
    tid = torch.arange(t)
    j = torch.cat([tid + it * b * t + u * t
                   for it in range(sh["mc"] // (b * t)) for u in range(b)])
    assert torch.equal(j.sort().values, torch.arange(sh["mc"]))
    return (torch.arange(sh["c"])[:, None] << (sh["log_m"] - sh["log_c"])) + j


def _slots(lb, k: int, log_u: int):
    """The slot of element lb + k 2^log_u (the kernels' one-pad shortcut
    from stride 32 on)."""
    if log_u >= 5:
        return pad32(lb) + k * ((1 << log_u) + (1 << (log_u - 5)))
    return pad32(lb + (k << log_u))


def _unsigned(t, v: torch.Tensor) -> torch.Tensor:
    """The tables' words as the kernels see them: u64 bit patterns as they
    are, int32 bit patterns as their u32 values."""
    return ma.u32_of_i32(v) if t.is_q32 else v


def _row_tables(t, roots, roots_s, lead: int):
    """Per polynomial row (rows = lead * L): the twiddle planes and q of its
    limb, as the kernels find them through limb_map."""
    key = t.limb_map.repeat(lead)
    return (_unsigned(t, roots[key]), _unsigned(t, roots_s[key]),
            _unsigned(t, t.key_q[key]).reshape(-1, 1, 1))


def _per_row(t, v: torch.Tensor, lead: int) -> torch.Tensor:
    """A per-limb constant (L,) as (rows, 1, 1): what each block reads once
    at its limb."""
    return _unsigned(t, v.reshape(-1).repeat(lead)).reshape(-1, 1, 1)


def _twiddles(w_rows, ws_rows, rows: int, c: int):
    """tw(idx): both tables at twiddle index idx (an int, or (C, k) per
    block), as (rows, C, k)."""
    def tw(idx):
        idx = torch.as_tensor(idx).expand(c, -1) if torch.is_tensor(idx) else \
            torch.full((c, 1), idx)
        return (w_rows[:, idx.reshape(-1)].reshape(rows, *idx.shape),
                ws_rows[:, idx.reshape(-1)].reshape(rows, *idx.shape))
    return tw


def final_reduce(q):
    """FinalReduce's bound form: each run [0, 4q) -> [0, q)."""
    def land(v: list, at) -> list:
        return [ma.csub(torch.where(e >= 2 * q, e - 2 * q, e), q) for e in v]
    return land


def landing(word: Word, t, q, lead: int, sub, post, post_s, pre=None, pre_s=None):
    """Landing's bound form: (sub - pre * y) * post mod q on each run, in
    fwd_rows' order, reading the run of `sub` at the same offsets (whole,
    16-byte aligned runs, as load_run reads them); the constants per row,
    read once."""
    wb = 4 if t.is_q32 else 8
    sub_rows = _unsigned(t, sub.reshape(-1, sub.shape[-1]))
    post, post_s = _per_row(t, post, lead), _per_row(t, post_s, lead)
    if pre is not None:
        pre, pre_s = _per_row(t, pre, lead), _per_row(t, pre_s, lead)
    reduce = final_reduce(q)

    def land(v: list, at) -> list:
        assert len(v) * wb % 16 == 0 and bool((at * wb % 16 == 0).all())
        runs = [sub_rows[:, (at + k).reshape(-1)].reshape(v[0].shape) for k in range(len(v))]
        out = []
        for y, s in zip(reduce(v, at), runs):
            if pre is not None:
                y = ma.csub(word.shoup_lazy(y, pre, pre_s, q), q)
            d = ma.csub(s + q - y, q)
            out.append(ma.csub(word.shoup_lazy(d, post, post_s, q), q))
        return out
    return land


def cluster_forward(x: torch.Tensor, t, log_c: int | None = None, land=None) -> torch.Tensor:
    """fwd_cluster on the tables' word ((..., L, N) int64 or int32), with
    FinalReduce or, given land = (sub, post, post_s, pre, pre_s) (pre pair
    may be None), the Landing epilogue."""
    word = Word(32 if t.is_q32 else 64)
    lead, n = x.shape[:-1], x.shape[-1]
    log_n = n.bit_length() - 1
    sh = cluster_shape(word.bits // 8, log_n, log_c)
    c, m, log_m, log_c = sh["c"], sh["m"], sh["log_m"], sh["log_c"]
    src = _unsigned(t, x.reshape(-1, n))
    rows = src.shape[0]
    per = rows // t.num_limbs
    w_rows, ws_rows, q = _row_tables(t, t.roots, t.roots_shoup, per)
    tw = _twiddles(w_rows, ws_rows, rows, c)
    epi = final_reduce(q) if land is None else landing(word, t, q, per, *land)

    buf = torch.zeros(rows, c, m + m // 32, dtype=torch.int64)
    if c > 1:
        col = _columns(sh)                                   # (C, M / C) per block r
        v = [src[:, (hi << log_m) + col] for hi in range(c)]
        radix_fwd(word, v, tw, log_c, 1, 0, q)
        for hi in range(c):                                  # push to block hi
            buf[:, hi, pad32(col.reshape(-1))] = v[hi].reshape(rows, -1)
    else:
        buf[:, 0, pad32(torch.arange(m))] = src

    out = torch.empty_like(src)
    chunk0 = (torch.arange(c) << log_m)[:, None]
    stage = log_c
    while stage < log_n:
        r = radix(log_n - stage)
        last = r == log_n - stage
        log_t = log_n - 1 - stage
        lu = log_t - (r - 1)
        qd = torch.arange(m >> r)
        lb = ((qd >> lu) << (lu + r)) | (qd & ((1 << lu) - 1))
        i = (chunk0 + lb) >> (log_t + 1)                     # (C, threads)
        slot = [_slots(lb, k, lu) for k in range(1 << r)]
        v = [buf[:, :, s] for s in slot]
        radix_fwd(word, v, tw, r, 1 << stage, i, q)
        if last:                                             # 2^r consecutive words
            at = chunk0 + lb
            for k, e in enumerate(epi(v, at)):
                out[:, (at + k).reshape(-1)] = e.reshape(rows, -1)
        else:
            for k, s in enumerate(slot):
                buf[:, :, s] = v[k]
        stage += r
    return (ma.i32_of_u32(out) if t.is_q32 else out).reshape(*lead, n)


def cluster_inverse(x: torch.Tensor, t, scale=None, scale_shoup=None,
                    log_c: int | None = None) -> torch.Tensor:
    """inv_cluster on the tables' word: (..., L, N) int64 or int32, scale
    (L,) or None."""
    word = Word(32 if t.is_q32 else 64)
    lead, n = x.shape[:-1], x.shape[-1]
    log_n = n.bit_length() - 1
    sh = cluster_shape(word.bits // 8, log_n, log_c)
    c, m, log_m, log_c = sh["c"], sh["m"], sh["log_m"], sh["log_c"]
    src = _unsigned(t, x.reshape(-1, n))
    rows = src.shape[0]
    per = rows // t.num_limbs
    w_rows, ws_rows, q = _row_tables(t, t.inv_roots, t.inv_roots_shoup, per)
    key = t.limb_map.repeat(per)
    f, fs = (_unsigned(t, v[key]).reshape(-1, 1, 1) for v in (t.inv_degree,
                                                               t.inv_degree_shoup))
    if scale is not None:
        s, ss = _per_row(t, scale, per), _per_row(t, scale_shoup, per)

    def epi(v):
        v = word.shoup_lazy(v, f, fs, q)
        if scale is not None:
            v = word.shoup_lazy(v, s, ss, q)
        return ma.csub(v, q)

    tw = _twiddles(w_rows, ws_rows, rows, c)
    buf = torch.zeros(rows, c, m + m // 32, dtype=torch.int64)
    out = torch.empty_like(src)
    chunk0 = (torch.arange(c) << log_m)[:, None]
    log_t = 0
    while log_t < log_m:
        r = radix(log_m - log_t)
        last = r == log_m - log_t
        qd = torch.arange(m >> r)
        lb = ((qd >> log_t) << (log_t + r)) | (qd & ((1 << log_t) - 1))
        i = (chunk0 + lb) >> (log_t + r)
        slot = [_slots(lb, k, log_t) for k in range(1 << r)]
        if log_t == 0:                                       # 2^r consecutive words
            v = [src[:, (chunk0 + lb + k).reshape(-1)].reshape(rows, c, -1)
                 for k in range(1 << r)]
        else:
            v = [buf[:, :, s_] for s_ in slot]
        radix_inv(word, v, tw, r, n >> (log_t + r), i, q)
        if last and c == 1:
            for k in range(1 << r):
                out[:, lb + (k << log_t)] = epi(v[k])[:, 0]
        else:
            for k, s_ in enumerate(slot):
                buf[:, :, s_] = v[k]
        log_t += r
    if c > 1:
        col = _columns(sh)                                   # block r's columns
        v = [buf[:, b, pad32(col.reshape(-1))].reshape(rows, c, -1) for b in range(c)]
        radix_inv(word, v, tw, log_c, 1, 0, q)
        for b in range(c):
            out[:, ((b << log_m) + col).reshape(-1)] = epi(v[b]).reshape(rows, -1)
    return (ma.i32_of_u32(out) if t.is_q32 else out).reshape(*lead, n)


# -- against the plain versions and the reference's golden transforms -------

def _word_tensor(word: int):
    return ma.u32_tensor if word == 4 else ma.u64_tensor


def _shoup(vals, qs, word: int):
    """floor(w * 2^(8 word) / q) per limb, in plain Python integers."""
    return _word_tensor(word)([(int(w) << (8 * word)) // int(q) for w, q in zip(vals, qs)],
                              "cpu")


@pytest.fixture(scope="module", params=[10, 11, 12, 13])
def ring(request):
    """Per word: the view (limb_map VIEW) of key-level tables, 2 rows of
    residues x and sub, per-limb constants with their Shoup words (scale,
    post, pre) and, on row (1, 0), the reference's golden transforms."""
    log_n = request.param
    n = 1 << log_n
    out = {"log_n": log_n}
    for word, bits in KEY_BITS.items():
        qs = [p.value for p in CoeffModulus.create(n, bits)]
        key = ntt.build_device_ntt_tables([make_ntt_tables(log_n, q) for q in qs], "cpu",
                                          q32=word == 4)
        view = key.slice_limbs(VIEW)
        vq = np.array([qs[i] for i in VIEW], dtype=np.uint64)
        rng = np.random.default_rng(100 * log_n + word)
        x, sub = (rng.integers(0, 2**62, size=(BATCH_ROWS, len(VIEW), n), dtype=np.uint64)
                  % vq[:, None] for _ in range(2))
        j_tab = j_make_ntt_tables(log_n, qs[VIEW[0]])
        d = dict(view=view, x=_word_tensor(word)(x, "cpu"), sub=_word_tensor(word)(sub, "cpu"),
                 golden_fwd=np.array(golden_forward_ntt([int(v) for v in x[1, 0]], j_tab),
                                     dtype=np.uint64),
                 golden_inv=np.array(golden_inverse_ntt([int(v) for v in x[1, 0]], j_tab),
                                     dtype=np.uint64),
                 sub_row=sub[1, 0], q0=int(vq[0]))
        for name in ("s", "post", "pre"):
            vals = rng.integers(0, 2**62, size=len(VIEW), dtype=np.uint64) % vq
            d[name] = (_word_tensor(word)(vals, "cpu"), _shoup(vals, vq, word))
        out[word] = d
    return out


@pytest.mark.parametrize("log_c", [0, 1, 2, 3])
def test_forward_push_schedule_u64(ring, log_c):
    d = ring[8]
    got = cluster_forward(d["x"], d["view"], log_c)
    assert got.dtype == torch.int64 and got.shape == d["x"].shape
    assert torch.equal(got, ntt.forward_ntt_plain(d["x"], d["view"]))
    np.testing.assert_array_equal(to_numpy(got)[1, 0], d["golden_fwd"])


@pytest.mark.parametrize("with_pre", [False, True])
@pytest.mark.parametrize("log_c", [0, 1, 2, 3])
def test_forward_landing_push_schedule_q32(ring, log_c, with_pre):
    """K6: the push schedule on q32 words with the Landing epilogue, with
    and without pre; on row (1, 0) the reference's golden forward
    transform followed by the landing in plain Python."""
    d = ring[4]
    pre = d["pre"] if with_pre else (None, None)
    args = (d["sub"], *d["post"], *pre)
    got = cluster_forward(d["x"], d["view"], log_c, land=args)
    assert got.dtype == torch.int32 and got.shape == d["x"].shape
    assert torch.equal(got, ntt.forward_ntt_sub_scale_plain(d["x"], d["sub"], d["view"], *args[1:]))
    q = d["q0"]
    post, pre_v = int(d["post"][0][0]), int(d["pre"][0][0]) if with_pre else 1
    want = [(int(s) - pre_v * int(y)) * post % q for s, y in zip(d["sub_row"], d["golden_fwd"])]
    np.testing.assert_array_equal(to_numpy(got)[1, 0], np.array(want, dtype=np.uint64))


@pytest.mark.parametrize("with_pre", [False, True])
@pytest.mark.parametrize("log_c", [0, 1, 2, 3])
def test_forward_landing_push_schedule_u64(ring, log_c, with_pre):
    """K3: the push schedule on u64 words with the Landing epilogue, with
    and without pre; on row (1, 0) the reference's golden forward
    transform followed by the landing in plain Python."""
    d = ring[8]
    pre = d["pre"] if with_pre else (None, None)
    args = (d["sub"], *d["post"], *pre)
    got = cluster_forward(d["x"], d["view"], log_c, land=args)
    assert got.dtype == torch.int64 and got.shape == d["x"].shape
    assert torch.equal(got, ntt.forward_ntt_sub_scale_plain(d["x"], d["sub"], d["view"], *args[1:]))
    q = d["q0"]
    post, pre_v = int(d["post"][0][0]), int(d["pre"][0][0]) if with_pre else 1
    want = [(int(s) - pre_v * int(y)) * post % q for s, y in zip(d["sub_row"], d["golden_fwd"])]
    np.testing.assert_array_equal(to_numpy(got)[1, 0], np.array(want, dtype=np.uint64))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("log_c", [0, 1, 2, 3])
def test_inverse_pull_schedule_q32(ring, log_c, scaled):
    d = ring[4]
    sc = d["s"] if scaled else (None, None)
    got = cluster_inverse(d["x"], d["view"], *sc, log_c=log_c)
    assert got.dtype == torch.int32 and got.shape == d["x"].shape
    assert torch.equal(got, ntt.inverse_ntt_plain(d["x"], d["view"], *sc))
    if not scaled:
        np.testing.assert_array_equal(to_numpy(got)[1, 0], d["golden_inv"])


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("log_c", [0, 1, 2, 3])
def test_inverse_pull_schedule_u64(ring, log_c, scaled):
    """K2: the pull schedule on u64 words, with and without scale."""
    d = ring[8]
    sc = d["s"] if scaled else (None, None)
    got = cluster_inverse(d["x"], d["view"], *sc, log_c=log_c)
    assert got.dtype == torch.int64 and got.shape == d["x"].shape
    assert torch.equal(got, ntt.inverse_ntt_plain(d["x"], d["view"], *sc))
    if not scaled:
        np.testing.assert_array_equal(to_numpy(got)[1, 0], d["golden_inv"])


def test_kernel_shapes_default():
    """At the kernels' own shapes (2^10 .. 2^13 here) the model equals the
    plain versions too; at every ring size it takes, ClusterShape meets the
    kernels' static checks and a block's 227 KB of shared memory."""
    for word in (4, 8):
        cs = [cluster_shape(word, log_n)["c"] for log_n in range(10, 18)]
        assert cs == ([1, 1, 1, 1, 2, 4, 4, 8] if word == 4 else [1, 1, 1, 2, 4, 4, 8, 8])
        for log_n in range(10, 18):
            sh = cluster_shape(word, log_n)
            assert sh["smem"] <= 232448 and sh["mc"] % (sh["batch"] * sh["threads"]) == 0
            assert (sh["m"] >> 3) // sh["threads"] >= 1
    qs = [p.value for p in CoeffModulus.create(1 << 13, KEY_BITS[8])]
    t = ntt.build_device_ntt_tables([make_ntt_tables(13, q) for q in qs], "cpu")
    x = np.random.default_rng(3).integers(0, 2**62, size=(4, 8192), dtype=np.uint64)
    x = ma.u64_tensor(x % np.array(qs, dtype=np.uint64)[:, None], "cpu")
    assert torch.equal(cluster_forward(x, t), ntt.forward_ntt_plain(x, t))
