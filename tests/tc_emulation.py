"""The tensor-core kernels' arithmetic, emulated in torch on the CPU:
3×TF32 products of float32 operands with per-chunk partial sums that the
tensor cores round toward zero (``csrc/l2_sm90.cuh``, and the float32
attention kernels' ``csrc/flash_sm90_f32.cuh``), and float32 FMA chains in
k order, and data that puts the assign kernel's re-check to the test.
Shared by ``test_torch_verify_tc.py``, ``test_torch_assign_tc.py``,
``test_torch_flash_f32_tc.py`` and ``test_torch_cuda.py`` (so it imports
nothing of the JAX package)."""
import numpy as np
import torch

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


def tc_emulation(a: torch.Tensor, b: torch.Tensor, eps2: float):
    """The kernel's arithmetic on (E, M, D) × (E, N, D) float32: norms as
    float32 FMAs in k order; a = a_hi + a_lo, b likewise, each half rounded
    to TF32; per 8-deep k step the products a_lo·b_hi, a_hi·b_lo and
    a_hi·b_hi, summed per 32-deep chunk into a fresh float32 partial (the
    chunk's lo·hi and hi·lo products k step by k step, then its hi·hi
    products) that is added to the total (round to nearest). The
    model of a tensor-core step: the 8 TF32 products and their sum with
    the partial exact (float64), then one rounding toward zero, since the
    tensor cores truncate where float32 FMAs round to nearest."""
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
    return d2, d2 <= eps2


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


def fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot products of float32 (..., D) tensors as one float32 FMA
    chain in k order, as the CUDA-core kernels and the norms of the
    tensor-core ones sum them (each step exact in float64, then rounded to
    float32)."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32)
    for k in range(a.shape[-1]):
        acc = (acc.double() + a[..., k].double() * b[..., k].double()).float()
    return acc


def three_way_ties(m: int, d: int, seed: int):
    """Rows each with three centers of their own at distance 0.3 along
    orthonormal directions, the three radii apart by a relative 1e-9 ..
    1e-5 (log-uniform): the three nearest d² lie within the tensor cores'
    error of each other (7e-7 |x|² in this data)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d))
    c = []
    for row in x:
        q, _ = np.linalg.qr(rng.normal(size=(d, 3)))
        tau = (np.exp(rng.uniform(np.log(1e-9), np.log(1e-5), size=3))
               * rng.choice([-1.0, 1.0], size=3))
        c.append(row[None] + (0.3 * (1 + tau))[:, None] * q.T)
    return x.astype(np.float32), np.concatenate(c).astype(np.float32)
