"""Chebyshev-series evaluation (direct and Paterson-Stockmeyer).

Port of ``tpu_fhe/eval/chebyshev.py``: EvalChebyshevSeries{,Linear,PS}
and InnerEvalChebyshevPS, and the host-side polynomial machinery they
need: Chebyshev-basis long division, the PS (k, m) parameter table, the
degree -> depth table and function-to-Chebyshev interpolation.  The host
math is plain Python floats, kept here as a copy; the ciphertext work goes
through the FLEXIBLEAUTO layer (``eval/auto.py``).
"""

from __future__ import annotations

import math

from ..scheme.ciphertext import Ciphertext
from ..scheme.context import FheContext
from ..scheme.keys import RelinKey
from . import auto


# --------------------------------------------------------------------------
# host-side polynomial helpers (src/util.cu)
# --------------------------------------------------------------------------

def degree(coeffs: list[float]) -> int:
    for i in range(len(coeffs) - 1, -1, -1):
        if coeffs[i]:
            return i
    return 0


_PREC = 2.0 ** -20


def _not_one(v: float) -> bool:
    return abs(v - 1.0) >= _PREC


def long_division_poly(f: list[float], g: list[float]):
    """Monomial-basis long division; returns (q, r)."""
    n, k = degree(f), degree(g)
    if n - k < 0:
        return [0.0], list(f)
    q = [0.0] * (n - k + 1)
    r = list(f)
    while n - k >= 0:
        d = [0.0] * (n - k) + list(g)
        q[n - k] = r[-1]
        if _not_one(g[k]):
            q[n - k] /= g[-1]
        d = [v * q[n - k] for v in d]
        r = [a - b for a, b in zip(r, d)]
        if len(r) > 1:
            n = degree(r)
            r = r[: n + 1]
    return q, r


def long_division_chebyshev(f: list[float], g: list[float]):
    """Chebyshev-basis long division (src/util.cu:158-265); zero-th
    coefficient convention is c0 (not c0/2) in and out."""
    n, k = degree(f), degree(g)
    if n - k < 0:
        return [0.0], list(f)
    q = [0.0] * (n - k + 1)
    r = list(f)
    while n - k > 0:
        d = [0.0] * (n + 1)
        q[n - k] = 2 * r[-1]
        if _not_one(g[k]):
            q[n - k] /= g[-1]
        if k == n - k:
            d[0] = 2 * g[n - k]
            for i in range(1, 2 * k + 1):
                d[i] = g[abs(n - k - i)]
        elif k > n - k:
            d[0] = 2 * g[n - k]
            for i in range(1, k - (n - k) + 1):
                d[i] = g[abs(n - k - i)] + g[n - k + i]
            for i in range(k - (n - k) + 1, n + 1):
                d[i] = g[abs(i - n + k)]
        else:
            d[n - k] = g[0]
            for i in range(n - 2 * k, n + 1):
                if i != n - k:
                    d[i] = g[abs(i - n + k)]
        if _not_one(r[-1]):
            d = [v * r[-1] for v in d]
        if _not_one(g[-1]):
            d = [v / g[-1] for v in d]
        r = [a - b for a, b in zip(r, d)]
        if len(r) > 1:
            n = degree(r)
            r = r[: n + 1]
    if n == k:
        d = list(g)
        q[0] = r[-1]
        if _not_one(g[-1]):
            q[0] /= g[-1]
        if _not_one(r[-1]):
            d = [v * r[-1] for v in d]
        if _not_one(g[-1]):
            d = [v / g[-1] for v in d]
        r = [a - b for a, b in zip(r, d)]
        if len(r) > 1:
            n = degree(r)
            r = r[: n + 1]
    q[0] *= 2  # convention: store c0, not c0/2
    return q, r


def _populate_parameter_ps() -> list[int]:
    """(k,m) table for PS up to degree 2204 (src/util.cu:15-38)."""
    ranges = [
        (0, 2, 1), (2, 11, 2), (11, 13, 3), (13, 17, 2), (17, 55, 3),
        (55, 59, 4), (59, 76, 3), (76, 239, 4), (239, 247, 5),
        (247, 284, 4), (284, 991, 5), (991, 1007, 6), (1007, 1083, 5),
        (1083, 2015, 6), (2015, 2031, 7), (2031, 2204, 6),
    ]
    mlist = [0] * 2204
    for lo, hi, m in ranges:
        for i in range(lo, hi):
            mlist[i] = m
    return mlist


_MLIST = _populate_parameter_ps()


def compute_degrees_ps(n: int) -> tuple[int, int]:
    if n == 0:
        raise ValueError("degree must be positive")
    if n <= 2204:
        m = _MLIST[n - 1]
        k = n // ((1 << m) - 1) + 1
        return k, m
    best = None
    for k in range(1, n + 1):
        for m in range(1, int(math.ceil(math.log2(n / k) + 1)) + 2):
            if n - k * ((1 << m) - 1) < 0:
                if abs(
                    math.floor(math.log2(k))
                    - math.floor(math.log2(math.sqrt(n / 2)))
                ) <= 1:
                    mults = k + 2 * m + (1 << (m - 1)) - 4
                    if best is None or mults < best[0]:
                        best = (mults, k, m)
    assert best is not None
    return best[1], best[2]


def _depth_by_degree_table() -> list[int]:
    ranges = [
        (0, 5, 3), (5, 6, 4), (6, 14, 5), (14, 28, 6), (28, 60, 7),
        (60, 120, 8), (120, 248, 9), (248, 496, 10), (496, 1008, 11),
        (1008, 2032, 12),
    ]
    t = [0] * 2032
    for lo, hi, d in ranges:
        for i in range(lo, hi):
            t[i] = d
    return t


_DEPTH_TABLE = _depth_by_degree_table()


def get_mult_depth_by_coeff_vector(coeffs: list[float], normalized: bool = True) -> int:
    deg = len(coeffs) - 1
    if not (5 <= deg <= 2031):
        raise ValueError("polynomial degree supported from 5 to 2031")
    d = _DEPTH_TABLE[deg]
    return d - 1 if normalized else d


def eval_chebyshev_coefficients(func, a: float, b: float, deg: int) -> list[float]:
    """Chebyshev interpolation coefficients of func on [a, b]
    (src/evaluate.cu EvalChebyshevCoefficients)."""
    if deg == 0:
        raise ValueError("degree cannot be zero")
    total = deg + 1
    bma = 0.5 * (b - a)
    bpa = 0.5 * (b + a)
    pi_by = math.pi / total
    pts = [func(math.cos(pi_by * (i + 0.5)) * bma + bpa) for i in range(total)]
    mult = 2.0 / total
    return [
        mult * sum(pts[j] * math.cos(pi_by * i * (j + 0.5)) for j in range(total))
        for i in range(total)
    ]


# --------------------------------------------------------------------------
# encrypted evaluation
# --------------------------------------------------------------------------

def eval_linear_wsum_mutable(
    ctx: FheContext, cts: list[Ciphertext], weights: list[float]
) -> Ciphertext:
    """Weighted sum with level adjustment (src/evaluate.cu:3537-3605)."""
    cts = list(cts)
    max_idx = 0
    for i in range(1, len(cts)):
        if cts[i].chain_index > cts[max_idx].chain_index or (
            cts[i].chain_index == cts[max_idx].chain_index
            and cts[i].noise_scale_deg == 2
        ):
            max_idx = i
    for i in range(len(cts)):
        if i != max_idx:
            cts[i], cts[max_idx] = auto.adjust_levels_and_depth(
                ctx, cts[i], cts[max_idx]
            )
    if cts[max_idx].noise_scale_deg == 2:
        cts = [auto.mod_reduce(ctx, c, 1) for c in cts]
    acc = auto.mult_const(ctx, cts[0], weights[0])
    for i in range(1, len(cts)):
        term = auto.mult_const(ctx, cts[i], weights[i])
        acc = auto.eval_add_auto(ctx, acc, term)
    return acc


def _build_cheb_basis(
    ctx: FheContext, x: Ciphertext, rlk: RelinKey, k: int, a: float, b: float
) -> list[Ciphertext]:
    """T[0..k-1] = T_1(y) ... T_k(y) via the binary product tree."""
    T: list[Ciphertext | None] = [None] * k
    if round(a) == -1 and round(b) == 1 and abs(a - round(a)) < 1e-10 and abs(
        b - round(b)
    ) < 1e-10:
        T[0] = x
    else:
        alpha = 2.0 / (b - a)
        beta = 2.0 * a / (b - a)
        t0 = auto.mult_const(ctx, x, alpha)
        T[0] = auto.add_const(ctx, t0, -1.0 - beta)
    y = T[0]
    for i in range(2, k + 1):
        if not (i & (i - 1)):  # power of two: T_{2j} = 2 T_j^2 - 1
            sq = auto.eval_square_auto(ctx, T[i // 2 - 1], rlk)
            t = auto.eval_add_auto(ctx, sq, sq)
            T[i - 1] = auto.add_const(ctx, t, -1.0)
        elif i % 2 == 1:  # odd: T_{2j+1} = 2 T_j T_{j+1} - y
            prod = auto.eval_mult_auto(ctx, T[i // 2 - 1], T[i // 2], rlk)
            t = auto.eval_add_auto(ctx, prod, prod)
            T[i - 1] = auto.eval_sub_auto(ctx, t, y)
        else:  # even non-power: T_{2j} = 2 T_j^2 - 1
            sq = auto.eval_square_auto(ctx, T[i // 2 - 1], rlk)
            t = auto.eval_add_auto(ctx, sq, sq)
            T[i - 1] = auto.add_const(ctx, t, -1.0)
    return T  # type: ignore[return-value]


def eval_chebyshev_series(
    ctx: FheContext,
    x: Ciphertext,
    rlk: RelinKey,
    coefficients: list[float],
    a: float,
    b: float,
) -> Ciphertext:
    if degree(coefficients) < 5:
        return eval_chebyshev_series_linear(ctx, x, rlk, coefficients, a, b)
    return eval_chebyshev_series_ps(ctx, x, rlk, coefficients, a, b)


def eval_chebyshev_series_linear(
    ctx, x, rlk, coefficients, a, b
) -> Ciphertext:
    k = len(coefficients) - 1
    T = _build_cheb_basis(ctx, x, rlk, k, a, b)
    result = auto.mult_const(ctx, T[k - 1], coefficients[k])
    for i in range(k - 1):
        if coefficients[i + 1] != 0:
            term = auto.mult_const(ctx, T[i], coefficients[i + 1])
            result = auto.eval_add_auto(ctx, result, term)
    return auto.add_const(ctx, result, coefficients[0] / 2)


def eval_chebyshev_series_ps(ctx, x, rlk, coefficients, a, b) -> Ciphertext:
    n = degree(coefficients)
    f2 = list(coefficients)
    if coefficients[-1] == 0:
        f2 = f2[: n + 1]
    k, m = compute_degrees_ps(n)

    T = _build_cheb_basis(ctx, x, rlk, k, a, b)
    for i in range(1, k):
        T[i - 1], T[k - 1] = auto.adjust_levels_and_depth(ctx, T[i - 1], T[k - 1])

    # T2[j] = T_{k 2^j}(y)
    T2: list[Ciphertext] = [T[k - 1]]
    for i in range(1, m):
        sq = auto.eval_square_auto(ctx, T2[i - 1], rlk)
        t = auto.eval_add_auto(ctx, sq, sq)
        T2.append(auto.add_const(ctx, t, -1.0))

    # T_{k(2^m - 1)}
    t2km1 = T2[0]
    for i in range(1, m):
        prod = auto.eval_mult_auto(ctx, t2km1, T2[i], rlk)
        t = auto.eval_add_auto(ctx, prod, prod)
        t2km1 = auto.eval_sub_auto(ctx, t, T2[0])

    k2m2k = k * (1 << (m - 1)) - k
    f2 = f2 + [0.0] * (2 * k2m2k + k + 1 - len(f2))
    f2[-1] = 1.0

    tkm = [0.0] * (k2m2k + k + 1)
    tkm[-1] = 1.0
    q_div, r_div = long_division_chebyshev(f2, tkm)

    r2 = list(r_div)
    if k2m2k - degree(r_div) <= 0:
        r2[k2m2k] -= 1
        r2 = r2[: degree(r2) + 1]
    else:
        r2 = r2 + [0.0] * (k2m2k + 1 - len(r2))
        r2[-1] = -1.0
    cs_q, cs_r = long_division_chebyshev(r2, q_div)
    s2 = list(cs_r) + [0.0] * (k2m2k + 1 - len(cs_r))
    s2[-1] = 1.0

    cu, flag_c = _eval_c(ctx, T, cs_q)
    qu = _eval_qs(
        ctx, x, rlk, q_div, k, m, T, T2, is_q=True
    )
    su = _eval_qs(ctx, x, rlk, s2, k, m, T, T2, is_q=False)

    if flag_c:
        result = auto.eval_add_auto(ctx, T2[m - 1], cu)
    else:
        result = auto.add_const(ctx, T2[m - 1], cs_q[0] / 2)
    result = auto.eval_mult_auto(ctx, result, qu, rlk)
    result = auto.eval_add_auto(ctx, result, su)
    result = auto.eval_sub_auto(ctx, result, t2km1)
    return result


def _eval_c(ctx, T, cs_q):
    dc = degree(cs_q)
    if dc < 1:
        return None, False
    if dc == 1:
        if cs_q[1] != 1:
            cu = auto.mult_const(ctx, T[0], cs_q[1])
        else:
            cu = T[0]
    else:
        cu = eval_linear_wsum_mutable(ctx, T[:dc], cs_q[1 : dc + 1])
    cu = auto.add_const(ctx, cu, cs_q[0] / 2)
    return cu, True


def _eval_qs(ctx, x, rlk, poly, k, m, T, T2, is_q: bool):
    """Evaluate quotient/remainder polynomial (recursive PS)."""
    if degree(poly) > k:
        return _inner_eval_chebyshev_ps(ctx, x, rlk, poly, k, m - 1, T, T2)
    pcopy = poly[:k] + [0.0] * max(0, k - len(poly))
    if degree(pcopy) > 0:
        d = degree(pcopy)
        out = eval_linear_wsum_mutable(ctx, T[:d], poly[1 : d + 1])
        if is_q:
            # top-level q: highest coefficient is always 2
            s = auto.eval_add_auto(ctx, T[k - 1], T[k - 1])
            out = auto.eval_add_auto(ctx, out, s)
        else:
            out = auto.eval_add_auto(ctx, out, T[k - 1])
    else:
        if is_q:
            out = T[k - 1]
            for _ in range(1, int(poly[degree(poly)])):
                out = auto.eval_add_auto(ctx, out, T[k - 1])
        else:
            out = T[k - 1]
    return auto.add_const(ctx, out, poly[0] / 2)


def _inner_eval_chebyshev_ps(ctx, x, rlk, coefficients, k, m, T, T2):
    """src/evaluate.cu:2998-3174."""
    k2m2k = k * (1 << (m - 1)) - k
    tkm = [0.0] * (k2m2k + k + 1)
    tkm[-1] = 1.0
    q_div, r_div = long_division_chebyshev(coefficients, tkm)

    r2 = list(r_div)
    if k2m2k - degree(r_div) <= 0:
        r2[k2m2k] -= 1
        r2 = r2[: degree(r2) + 1]
    else:
        r2 = r2 + [0.0] * (k2m2k + 1 - len(r2))
        r2[-1] = -1.0
    cs_q, cs_r = long_division_chebyshev(r2, q_div)
    s2 = list(cs_r) + [0.0] * (k2m2k + 1 - len(cs_r))
    s2[-1] = 1.0

    cu, flag_c = _eval_c(ctx, T, cs_q)

    if degree(q_div) > k:
        qu = _inner_eval_chebyshev_ps(ctx, x, rlk, q_div, k, m - 1, T, T2)
    else:
        qcopy = q_div[:k] + [0.0] * max(0, k - len(q_div))
        if degree(qcopy) > 0:
            d = degree(qcopy)
            qu = eval_linear_wsum_mutable(ctx, T[:d], q_div[1 : d + 1])
            # highest-order coeff is a power of two up to 2^{m-1}
            s = T[k - 1]
            for _ in range(int(math.log2(q_div[degree(q_div)]))):
                s = auto.eval_add_auto(ctx, s, s)
            qu = auto.eval_add_auto(ctx, qu, s)
        else:
            s = T[k - 1]
            for _ in range(int(math.log2(q_div[degree(q_div)]))):
                s = auto.eval_add_auto(ctx, s, s)
            qu = s
        qu = auto.add_const(ctx, qu, q_div[0] / 2)

    if degree(s2) > k:
        su = _inner_eval_chebyshev_ps(ctx, x, rlk, s2, k, m - 1, T, T2)
    else:
        scopy = s2[:k] + [0.0] * max(0, k - len(s2))
        if degree(scopy) > 0:
            d = degree(scopy)
            su = eval_linear_wsum_mutable(ctx, T[:d], s2[1 : d + 1])
            su = auto.eval_add_auto(ctx, su, T[k - 1])
        else:
            su = T[k - 1]
        su = auto.add_const(ctx, su, s2[0] / 2)

    if flag_c:
        result = auto.eval_add_auto(ctx, T2[m - 1], cu)
    else:
        result = auto.add_const(ctx, T2[m - 1], cs_q[0] / 2)
    result = auto.eval_mult_auto(ctx, result, qu, rlk)
    result = auto.eval_add_auto(ctx, result, su)
    return result
