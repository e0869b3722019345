"""The tensor-core kernels' arithmetic, emulated in torch on the CPU:
3×TF32 products of float32 operands with per-chunk partial sums that the
tensor cores round toward zero (``csrc/l2_sm90.cuh``, and the float32
attention kernels' ``csrc/flash_sm90_f32.cuh``); the CUDA-core kernels'
float32 FMA chains in k order (``csrc/l2_tile.cuh``), each FMA rounded
once; the band inside which the verify kernel recomputes a pair in the
CUDA-core arithmetic; and data that puts the re-checks to the test:
near-ε lanes and rows with three or four tied centers. Shared by
``test_torch_verify_tc.py``, ``test_torch_assign_tc.py``,
``test_torch_flash_f32_tc.py`` and ``test_torch_cuda.py`` (so it imports
nothing of the JAX package)."""
import numpy as np
import torch

from repro_torch.kernels.pairwise_l2 import band_scale

# two float32 evaluations of |x|² + |c|² − 2 x·c in different orders may
# rank two centers differently only where their exact d² lie closer than
# this share of |x|²: the largest such gap seen in the near-tie data was
# 6.9e-7 (emulated tensor cores) and 5.8e-7 (the JAX package's order)
F32_ORDER_GAP = 2.0 ** -20


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 (10 stored mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude, then clear them (a carry rounds into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 → float32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tc_emulation(a: torch.Tensor, b: torch.Tensor, eps2: float,
                 recheck: bool = True):
    """The kernel's arithmetic on (E, M, D) × (E, N, D) float32: norms as
    float32 FMAs in k order; a = a_hi + a_lo, b likewise, each half rounded
    to TF32; per 8-deep k step the products a_lo·b_hi, a_hi·b_lo and
    a_hi·b_hi, summed per 32-deep chunk into a fresh float32 partial (the
    chunk's lo·hi and hi·lo products k step by k step, then its hi·hi
    products) that is added to the total (round to nearest). The
    model of a tensor-core step: the 8 TF32 products and their sum with
    the partial exact (float64), then one rounding toward zero, since the
    tensor cores truncate where float32 FMAs round to nearest. With
    ``recheck`` (the verify kernel), every pair whose d² lies within
    ``band`` of ``eps2`` takes ``simt_emulation``'s d²; without it, the
    tensor cores' own (the assign kernel's first pass)."""
    def split(x):
        hi = tf32_rna(x)
        return hi, tf32_rna(x - hi)

    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[1])
    for c0 in range(0, a.shape[-1], 32):
        steps = range(c0, min(c0 + 32, a.shape[-1]), 8)
        order = [(k0, x, y) for k0 in steps
                 for x, y in ((a_lo, b_hi), (a_hi, b_lo))]
        order += [(k0, a_hi, b_hi) for k0 in steps]
        part = torch.zeros_like(acc)
        for k0, x, y in order:
            ks = slice(k0, k0 + 8)
            p = x[..., ks].double() @ y[..., ks].double().transpose(1, 2)
            part = round_toward_zero(part.double() + p)
        acc = acc + part
    d2 = torch.clamp_min((fma_dot(a, a)[..., :, None]
                          + fma_dot(b, b)[..., None, :]) - 2.0 * acc, 0.0)
    if recheck:
        inside = (d2.double() - eps2).abs() <= band(a, b)
        d2 = torch.where(inside, simt_emulation(a, b, eps2)[0], d2)
    return d2, d2 <= eps2


def simt_emulation(a: torch.Tensor, b: torch.Tensor, eps2: float):
    """The CUDA-core kernel's function (``csrc/pairwise_l2.cu``) on
    (E, M, D) × (E, N, D) float32: the norms and every dot product as
    float32 FMA chains in k order, then max(‖a‖² + ‖b‖² − 2 a·b, 0) with
    the sum of the norms rounded once and the difference once (the
    doubling is exact, so it is also ``fmaf(-2, dot, na + nb)``)."""
    d2 = torch.clamp_min((fma_dot(a, a)[..., :, None]
                          + fma_dot(b, b)[..., None, :])
                         - 2.0 * fma_pair_dots(a, b), 0.0)
    return d2, d2 <= eps2


def band(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, N) float64: the half-width of the verify kernel's re-check
    band around ε² (``csrc/l2_sm90.cuh``), κ(D)·2⁻²³·(‖a‖² + ‖b‖²) +
    2⁻¹⁰⁰, with the norms as the kernel sums them; −1 (no band) where the
    norms sum to 2¹⁰⁰ or more (pad rows)."""
    s = fma_dot(a, a)[..., :, None] + fma_dot(b, b)[..., None, :]
    w = band_scale(a.shape[-1]) * s.double() + 2.0 ** -100
    return torch.where(s < 2.0 ** 100, w, torch.full_like(w, -1.0))


def tc3_partials(a: torch.Tensor, b: torch.Tensor, chunk: int = 32):
    """a (..., M, K) @ b (..., K, N) of float32 as the float32 attention
    kernels take it (``csrc/flash_sm90_f32.cuh``): a = a_hi + a_lo and b
    likewise, each half rounded to TF32; K in chunks of ``chunk``, each
    chunk's products into a fresh float32 partial, per 8-deep k step
    a_lo·b_hi and a_hi·b_lo (k step by k step), then a_hi·b_hi, each
    step's products and the partial summed exactly (float64) and rounded
    toward zero, as the tensor cores do. → the chunks' partials in K order
    (``chunk`` ≥ K: one accumulator over the whole walk)."""
    def split(x):
        hi = tf32_rna(x)
        return hi, tf32_rna(x - hi)

    (a_hi, a_lo), (b_hi, b_lo) = split(a.float()), split(b.float())
    out = []
    for c0 in range(0, a.shape[-1], chunk):
        steps = range(c0, min(c0 + chunk, a.shape[-1]), 8)
        order = [(k0, x, y) for k0 in steps
                 for x, y in ((a_lo, b_hi), (a_hi, b_lo))]
        order += [(k0, a_hi, b_hi) for k0 in steps]
        part = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
        for k0, x, y in order:
            p = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            part = round_toward_zero(part + p).double()
        out.append(part.float())
    return out


def tc3_matmul(a: torch.Tensor, b: torch.Tensor, chunk: int = 32):
    """``tc3_partials`` added in K order into a float32 total (round to
    nearest), as the kernels add each partial."""
    parts = tc3_partials(a, b, chunk)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def fma_f32(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor):
    """float32 ``fmaf(x, y, acc)``: x·y + acc rounded once to float32 (to
    nearest, ties to even). The product is exact in float64 and the sum's
    rounding error comes from TwoSum, so float64's sum s is rounded to
    float32 directly unless it lies half-way between two float32s, where
    the error says which way the exact sum lies."""
    p = x.double() * y.double()
    c = acc.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)       # s + err == p + c exactly
    f = s.float()
    g = torch.nextafter(f, torch.where(s > f.double(), torch.inf,
                                       -torch.inf).float())
    tie = (f.double() + g.double()) * 0.5 == s
    up = torch.where(err > 0, torch.maximum(f, g), torch.minimum(f, g))
    return torch.where(tie & (err != 0), up, f)


def fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products of float32 (..., D) tensors as one float32 FMA
    chain in k order, as the CUDA-core kernels and the norms of the
    tensor-core ones sum them."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32)
    for k in range(a.shape[-1]):
        acc = fma_f32(a[..., k], b[..., k], acc)
    return acc


def fma_pair_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, D) × (..., N, D) float32 → (..., M, N): every pair's dot
    product as one float32 FMA chain in k order (``fma_dot`` of each
    pair)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32)
    for k in range(a.shape[-1]):
        acc = fma_f32(a[..., k, None], b[..., None, :, k], acc)
    return acc


def near_eps_lanes(e: int, m: int, n: int, d: int, seed: int,
                   near: int = 0):
    """(a (e, m, d), b (e, n, d), ε²) float32 lanes at the smoke join's
    scale (|x|² ≈ 12, ε² 0.1): in each lane the first ``near`` (default
    min(m, n) // 2) rows of b sit at float64 d² = ε²·(1 ± τ) from a row
    of a each, τ log-uniform in 1e-9 .. 1e-5, beside ordinary rows near
    the lane's a rows. Each near pair is placed along a random direction,
    rounded to float32, then walked to its target d² one coordinate at a
    time (coarse coordinates first), so the float64 d² of the float32 rows
    lands within 1e-10·ε² of ε²·(1 ± τ) from d = 96 (1e-7·ε² at d = 4)."""
    rng = np.random.default_rng(seed)
    eps2 = 0.1
    near = near or min(m, n) // 2
    scale = np.sqrt(12.0 / d)
    a = (rng.normal(size=(e, m, d)) * scale).astype(np.float32)
    b = (a[:, rng.integers(0, m, size=n)]
         + rng.normal(size=(e, n, d)) * 0.15 / np.sqrt(d)).astype(np.float32)
    for lane in range(e):
        src = rng.choice(m, size=near, replace=False)
        tau = (np.exp(rng.uniform(np.log(1e-9), np.log(1e-5), size=near))
               * rng.choice([-1.0, 1.0], size=near))
        target = eps2 * (1.0 + tau)
        u = rng.normal(size=(near, d))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        x = a[lane, src].astype(np.float64)
        y = (x + np.sqrt(target)[:, None] * u).astype(np.float32)
        for k in np.argsort(-np.abs(u), axis=1).T:  # coarse to fine
            rows = np.arange(near)
            diff = y[rows, k].astype(np.float64) - x[rows, k]
            miss = target - ((y.astype(np.float64) - x) ** 2).sum(1)
            step = miss / (2.0 * diff)   # d(d²)/d(y_k) = 2 (y_k − x_k)
            y[rows, k] = (y[rows, k] + step).astype(np.float32)
        b[lane, :near] = y
    return a, b, float(np.float32(eps2))


def _tied_centers(m: int, d: int, seed: int, k: int):
    """Rows each with k centers of their own at distance 0.3 along
    orthonormal directions, the k radii apart by a relative 1e-9 .. 1e-5
    (log-uniform): the k nearest d² lie within the tensor cores' error of
    each other (7e-7 |x|² in this data)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d))
    c = []
    for row in x:
        q, _ = np.linalg.qr(rng.normal(size=(d, k)))
        tau = (np.exp(rng.uniform(np.log(1e-9), np.log(1e-5), size=k))
               * rng.choice([-1.0, 1.0], size=k))
        c.append(row[None] + (0.3 * (1 + tau))[:, None] * q.T)
    return (np.ascontiguousarray(x, np.float32),
            np.ascontiguousarray(np.concatenate(c), np.float32))


def three_way_ties(m: int, d: int, seed: int):
    """``_tied_centers`` with three centers a row."""
    return _tied_centers(m, d, seed, 3)


def four_way_ties(m: int, d: int, seed: int):
    """``_tied_centers`` with four centers a row."""
    return _tied_centers(m, d, seed, 4)
