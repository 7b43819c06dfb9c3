"""Host-side bootstrap combinatorics (pure NumPy/complex128).

The port's own copy of ``tpu_fhe/boot/boot_math.py``, line for line: the
collapsed-FFT coefficient construction (CoeffEncodingCollapse /
CoeffDecodingCollapse), layer selection, the BSGS parameters and the
rotation helpers of the bootstrap's linear transforms.  It is exact scheme
mathematics on the host, kept identical to the reference so that the
C2S/S2C plaintexts are bit-identical (tests/test_torch_boot_math.py).
"""

from __future__ import annotations

import math

import numpy as np


def reduce_rotation(index: int, slots: int) -> int:
    """Normalize a rotation index into [0, slots) (src/util.cu:355-368)."""
    if slots & (slots - 1) == 0:
        n = int(math.log2(slots))
        if index >= 0:
            return index - ((index >> n) << n)
        return index + slots + ((abs(index) >> n) << n)
    return (slots + index % slots) % slots


def rotate_vec(a: np.ndarray, index: int) -> np.ndarray:
    """Left-rotate by index with the reference's range normalization."""
    slots = len(a)
    if index < 0 or index > slots:
        index = reduce_rotation(index, slots)
    if index == 0:
        return a.copy()
    return np.concatenate([a[index:], a[:index]])


def fill_vec(a: np.ndarray, slots: int) -> np.ndarray:
    reps = [a[i % len(a)] for i in range(slots)]
    return np.array(reps, dtype=np.complex128)


def extract_shifted_diagonal(A: np.ndarray, index: int) -> np.ndarray:
    rows, cols = A.shape
    return np.array(
        [A[k % rows][(k + index) % cols] for k in range(cols)],
        dtype=np.complex128,
    )


def select_layers(log_slots: int, budget: int) -> tuple[int, int, int]:
    """(layers per collapsed level, rows, remainder) — src/util.cu:733-766."""
    layers = math.ceil(log_slots / budget)
    rows = log_slots // layers
    rem = log_slots % layers
    dim = rows if rem == 0 else rows + 1
    if dim < budget:
        layers -= 1
        rows = log_slots // layers
        rem = log_slots - rows * layers
        dim = rows if rem == 0 else rows + 1
        while dim != budget:
            rows -= 1
            rem = log_slots - rows * layers
            dim = rows if rem == 0 else rows + 1
    return layers, rows, rem


# CKKS_BOOT_PARAMS field indices (src/util.cu:814-816)
LEVEL_BUDGET = 0
LAYERS_COLL = 1
LAYERS_REM = 2
NUM_ROTATIONS = 3
BABY_STEP = 4
GIANT_STEP = 5
NUM_ROTATIONS_REM = 6
BABY_STEP_REM = 7
GIANT_STEP_REM = 8


def get_collapsed_fft_params(
    slots: int, level_budget: int, dim1: int = 0
) -> list[int]:
    log_slots = max(1, int(math.log2(slots)))
    layers, _rows, rem = select_layers(log_slots, level_budget)
    flag_rem = rem != 0
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1
    if dim1 == 0 or dim1 > num_rot:
        g = 1 << (layers // 2 + 2) if num_rot > 7 else 1 << (layers // 2 + 1)
    else:
        g = dim1
    b = (num_rot + 1) // g
    b_rem = g_rem = 0
    if flag_rem:
        g_rem = 1 << (rem // 2 + 2) if num_rot_rem > 7 else 1 << (rem // 2 + 1)
        b_rem = (num_rot_rem + 1) // g_rem
    return [level_budget, layers, rem, num_rot, b, g, num_rot_rem, b_rem, g_rem]


def _coeff_one_level(
    pows: np.ndarray, rot_group: np.ndarray, flag_i: bool, encoding: bool
) -> list[np.ndarray]:
    """CoeffEncodingOneLevel / CoeffDecodingOneLevel (src/util.cu:380-480).

    Returns 3*log2(slots) weight vectors: [shift-right | unshifted |
    shift-left] blocks of log2(slots) rows each."""
    dim = len(pows) - 1
    slots = len(rot_group)
    logs = int(math.log2(slots))
    coeff = [np.zeros(slots, dtype=np.complex128) for _ in range(3 * logs)]
    i_unit = np.exp(-0.5j * math.pi) if encoding else np.exp(0.5j * math.pi)

    if encoding:
        m = slots
        while m > 1:
            s = int(math.log2(m)) - 1
            for k in range(0, slots, m):
                lenh = m >> 1
                lenq = m << 2
                for j in range(lenh):
                    j_tw = (lenq - (rot_group[j] % lenq)) * (dim // lenq)
                    if flag_i and m == 2:
                        w = i_unit * pows[j_tw]
                        coeff[s + logs][j + k] = i_unit
                        coeff[s + 2 * logs][j + k] = i_unit
                        coeff[s + logs][j + k + lenh] = -w
                        coeff[s][j + k + lenh] = w
                    else:
                        w = pows[j_tw]
                        coeff[s + logs][j + k] = 1
                        coeff[s + 2 * logs][j + k] = 1
                        coeff[s + logs][j + k + lenh] = -w
                        coeff[s][j + k + lenh] = w
            m >>= 1
    else:
        m = 2
        while m <= slots:
            s = int(math.log2(m)) - 1
            for k in range(0, slots, m):
                lenh = m >> 1
                lenq = m << 2
                for j in range(lenh):
                    j_tw = (rot_group[j] % lenq) * (dim // lenq)
                    if flag_i and m == 2:
                        w = i_unit * pows[j_tw]
                        coeff[s + logs][j + k] = i_unit
                        coeff[s + 2 * logs][j + k] = w
                        coeff[s + logs][j + k + lenh] = -w
                        coeff[s][j + k + lenh] = i_unit
                    else:
                        w = pows[j_tw]
                        coeff[s + logs][j + k] = 1
                        coeff[s + 2 * logs][j + k] = w
                        coeff[s + logs][j + k + lenh] = -w
                        coeff[s][j + k + lenh] = 1
            m <<= 1
    return coeff


def coeff_encoding_collapse(
    pows: np.ndarray, rot_group: np.ndarray, level_budget: int, flag_i: bool
) -> list[list[np.ndarray]]:
    """CoeffEncodingCollapse (src/util.cu:481-601)."""
    slots = len(rot_group)
    logs = int(math.log2(slots))
    layers, _rows, rem = select_layers(logs, level_budget)
    dim_collapse = level_budget
    flag_rem = 1 if rem else 0
    stop = 0 if rem else -1
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1

    coeff1 = _coeff_one_level(pows, rot_group, flag_i, encoding=True)

    coeff: list[list[np.ndarray]] = []
    for i in range(dim_collapse):
        rot_count = num_rot_rem if (flag_rem and i == 0) else num_rot
        coeff.append([np.zeros(slots, dtype=np.complex128) for _ in range(rot_count)])

    for s in range(dim_collapse - 1, stop, -1):
        top = logs - (dim_collapse - 1 - s) * layers - 1
        for l in range(layers):
            if l == 0:
                coeff[s][0] = coeff1[top].copy()
                coeff[s][1] = coeff1[top + logs].copy()
                coeff[s][2] = coeff1[top + 2 * logs].copy()
            else:
                temp = coeff[s]
                coeff[s] = [
                    np.zeros(slots, dtype=np.complex128) for _ in range(num_rot)
                ]
                # vectorized: temp[u][(k -+ r) mod slots] == np.roll(temp[u], +-r)
                r = 1 << (top - l)
                t = 0
                for u in range((1 << (l + 1)) - 1):
                    coeff[s][u + t] += coeff1[top - l] * np.roll(temp[u], r)
                    coeff[s][u + t + 1] += coeff1[top - l + logs] * temp[u]
                    coeff[s][u + t + 2] += (
                        coeff1[top - l + 2 * logs] * np.roll(temp[u], -r)
                    )
                    t += 1

    if flag_rem:
        s = 0
        top = logs - (dim_collapse - 1 - s) * layers - 1
        for l in range(rem):
            if l == 0:
                coeff[s][0] = coeff1[top].copy()
                coeff[s][1] = coeff1[top + logs].copy()
                coeff[s][2] = coeff1[top + 2 * logs].copy()
            else:
                temp = coeff[s]
                coeff[s] = [
                    np.zeros(slots, dtype=np.complex128) for _ in range(num_rot_rem)
                ]
                # vectorized: temp[u][(k -+ r) mod slots] == np.roll(temp[u], +-r)
                r = 1 << (top - l)
                t = 0
                for u in range((1 << (l + 1)) - 1):
                    coeff[s][u + t] += coeff1[top - l] * np.roll(temp[u], r)
                    coeff[s][u + t + 1] += coeff1[top - l + logs] * temp[u]
                    coeff[s][u + t + 2] += (
                        coeff1[top - l + 2 * logs] * np.roll(temp[u], -r)
                    )
                    t += 1
    return coeff


def coeff_decoding_collapse(
    pows: np.ndarray, rot_group: np.ndarray, level_budget: int, flag_i: bool
) -> list[list[np.ndarray]]:
    """CoeffDecodingCollapse (src/util.cu:602-731)."""
    slots = len(rot_group)
    logs = int(math.log2(slots))
    layers, rows, rem = select_layers(logs, level_budget)
    dim_collapse = level_budget
    flag_rem = 1 if rem else 0
    num_rot = (1 << (layers + 1)) - 1
    num_rot_rem = (1 << (rem + 1)) - 1

    coeff1 = _coeff_one_level(pows, rot_group, flag_i, encoding=False)

    coeff: list[list[np.ndarray]] = []
    for i in range(dim_collapse):
        rot_count = num_rot_rem if (flag_rem and i == level_budget - 1) else num_rot
        coeff.append([np.zeros(slots, dtype=np.complex128) for _ in range(rot_count)])

    for s in range(rows):
        for l in range(layers):
            if l == 0:
                coeff[s][0] = coeff1[s * layers].copy()
                coeff[s][1] = coeff1[logs + s * layers].copy()
                coeff[s][2] = coeff1[2 * logs + s * layers].copy()
            else:
                temp = coeff[s]
                coeff[s] = [
                    np.zeros(slots, dtype=np.complex128) for _ in range(num_rot)
                ]
                for u in range((1 << (l + 1)) - 1):
                    coeff[s][u] += coeff1[s * layers + l] * temp[u]
                    coeff[s][u + (1 << l)] += (
                        coeff1[s * layers + l + logs] * temp[u]
                    )
                    coeff[s][u + (1 << (l + 1))] += (
                        coeff1[s * layers + l + 2 * logs] * temp[u]
                    )

    if flag_rem:
        s = rows
        for l in range(rem):
            if l == 0:
                coeff[s][0] = coeff1[s * layers].copy()
                coeff[s][1] = coeff1[logs + s * layers].copy()
                coeff[s][2] = coeff1[2 * logs + s * layers].copy()
            else:
                temp = coeff[s]
                coeff[s] = [
                    np.zeros(slots, dtype=np.complex128) for _ in range(num_rot_rem)
                ]
                for u in range((1 << (l + 1)) - 1):
                    coeff[s][u] += coeff1[s * layers + l] * temp[u]
                    coeff[s][u + (1 << l)] += (
                        coeff1[s * layers + l + logs] * temp[u]
                    )
                    coeff[s][u + (1 << (l + 1))] += (
                        coeff1[s * layers + l + 2 * logs] * temp[u]
                    )
    return coeff
