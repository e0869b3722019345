"""The plain reference: brute-force ε-joins and ε-range queries.

Plain PyTorch in blocks of rows, on whatever device the caller names. It
imports nothing of the program (``repro_torch``) and nothing of the JAX
package, and it works from the inputs the benchmark made (the vectors, ε,
the queries), never from anything the program derived from them.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: the same arithmetic as a float32 program would do it, with each
product's operands rounded to TF32 (10 mantissa bits, rounded to nearest,
ties away, as the tensor cores' ``cvt.rna.tf32`` does), the products
summed in float32 (exact for TF32 operands). It is the reference put in
the program's place one precision below the configuration's float32, and
the comparison has to find it wrong.
"""
from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 2048


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (ties away from zero), as float32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(x: torch.Tensor, precision: str):
    """(rows for the dot products, squared norms) in ``precision``."""
    if precision == "float64":
        x = x.double()
        return x, (x * x).sum(1)
    if precision == "tf32":
        x = x.float()
        return to_tf32(x), (x * x).sum(1)
    raise ValueError(f"precision must be 'float64' or 'tf32', "
                     f"got {precision!r}")


def _d2(a, sa, b, sb) -> torch.Tensor:
    return (sa[:, None] - 2.0 * (a @ b.T) + sb[None, :]).clamp_min(0)


def pair_d2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
            block: int = 1 << 20) -> torch.Tensor:
    """float64 ‖x_i − x_j‖², computed from the differences."""
    out = []
    for k0 in range(0, i.numel(), block):
        d = x[i[k0:k0 + block]].double() - x[j[k0:k0 + block]].double()
        out.append((d * d).sum(1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64,
                                                  device=x.device)


def join(x: torch.Tensor, eps: float, precision: str = "float64",
         block: int = ROW_BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pair i < j with d² ≤ ε² → (pairs (P, 2) int64, d² (P,)),
    d² in ``precision``'s arithmetic (float64, or float32 for TF32)."""
    a_all, s_all = _operands(x, precision)
    eps2 = (float(eps) * float(eps) if precision == "float64"
            else float(np.float32(float(eps) * float(eps))))
    n = x.shape[0]
    pairs, d2s = [], []
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        d2 = _d2(a_all[i0:i1], s_all[i0:i1], a_all[i0:], s_all[i0:])
        r, c = torch.nonzero(d2 <= eps2, as_tuple=True)
        keep = c > r        # columns start at row i0: upper triangle
        r, c = r[keep], c[keep]
        pairs.append(torch.stack([r + i0, c + i0], 1))
        d2s.append(d2[r, c])
    return torch.cat(pairs), torch.cat(d2s)


def members(x: torch.Tensor, Q: torch.Tensor, eps: float,
            precision: str = "float64", block: int = 256
            ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each query's rows within ε → [(ids, d²)], ids ascending."""
    a_all, s_all = _operands(x, precision)
    q_all, sq_all = _operands(Q, precision)
    eps2 = (float(eps) * float(eps) if precision == "float64"
            else float(np.float32(float(eps) * float(eps))))
    out = []
    for i0 in range(0, Q.shape[0], block):
        d2 = _d2(q_all[i0:i0 + block], sq_all[i0:i0 + block], a_all, s_all)
        qi, j = torch.nonzero(d2 <= eps2, as_tuple=True)
        vals = d2[qi, j].cpu().numpy()
        qi, j = qi.cpu().numpy(), j.cpu().numpy()
        cuts = np.searchsorted(qi, np.arange(d2.shape[0] + 1))
        out += [(j[cuts[k]:cuts[k + 1]].astype(np.int64),
                 vals[cuts[k]:cuts[k + 1]]) for k in range(d2.shape[0])]
    return out
