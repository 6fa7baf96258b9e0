"""Plain PyTorch versions of the kernels.

Each function has its kernel's signature (``kernels/ops.py``).  The parser's
have a leading batch-of-chunks axis: one call covers every chunk of every
batch row.  They are the ``torch`` backend's phase bodies, the CPU path of
every kernel wrapper, and what the CUDA kernels are held against on the card.
The parser's arithmetic is OR-AND over {0,1}: f32 matmul then min(·, 1) for
the dense kernels, int32 words holding the uint32 bit pattern for the packed
ones.  It is exact, so a kernel and its plain version agree bit for bit.  The
two LM kernels (``flash_attention_ref``, ``ssd_chunk_ref``) are float, and are
held to the reference's tolerances; they compute in f32, or in f64 for f64
inputs (``_wide``: the gradient checks' type).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..core.matrices import pack_bits_torch, packed_identity, packed_semiring_matmul


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or kept in f64."""
    return t if t.dtype == torch.float64 else t.float()


def semiring_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean product clamp(a @ b) of (…, m, k) × (…, k, n) {0,1} f32.

    The operands must hold only 0 and 1: K3 rounds them to bf16, exact on
    those values only, so this f32 product is its plain version there alone.
    """
    return torch.clamp(torch.matmul(a, b), max=1.0)


def tenant_of_chunk(n_tenants: int, n_chunks: int, device=None) -> torch.Tensor:
    """(C,) int64 tenant index of each of C = T·Ct chunks, tenant by tenant."""
    if n_chunks % max(n_tenants, 1):
        raise ValueError(f"{n_chunks} chunks do not split evenly over {n_tenants} tenants")
    return torch.arange(n_chunks, device=device) // max(n_chunks // max(n_tenants, 1), 1)


def class_tables(N: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The table of each chunk's class: ``N[ids]`` for a shared table N
    (A+1, …, …), or each chunk's own tenant's, ``N[tenant, ids]``, for a
    tenant stack (T, A+1, …, …).  ids (C, …) → (C, …, ·, ·)."""
    if N.dim() == 3:
        return N[ids]
    tix = tenant_of_chunk(N.shape[0], ids.shape[0], ids.device)
    return N[tix.view((-1,) + (1,) * (ids.dim() - 1)), ids]


def reach_chunk_product_ref(N: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Chunk products P = N[x_k] ⊗ … ⊗ N[x_1] of C chunks at once.

    N (A+1, ℓp, ℓp) f32 {0,1} with the PAD class the identity, or a tenant
    stack (T, A+1, ℓp, ℓp); ids (C, k) int class ids → (C, ℓp, ℓp) f32.
    """
    C, k = ids.shape
    lp = N.shape[-1]
    P = torch.eye(lp, dtype=N.dtype, device=N.device).expand(C, lp, lp).contiguous()
    for t in range(k):
        P = semiring_matmul_ref(class_tables(N, ids[:, t]), P)
    return P


def build_merge_chunk_ref(
    N: torch.Tensor, ids: torch.Tensor, entry_f: torch.Tensor, entry_b: torch.Tensor
) -> torch.Tensor:
    """Fig. 14 builder&merger of C chunks: (C, k, ℓp) f32 clean columns.

    Forward from J_{i-1}: fwd[t] = clamp(N[x_t] fwd[t-1]).  Backward from
    Ĵ_{i+1}: β_k = entry_b, β_t = clamp(N[x_t]ᵀ β_{t+1}).  Column t is
    fwd[t] ∧ β_{t+1}.  entry_f, entry_b (C, ℓp) f32; N shared or a tenant
    stack, as for :func:`reach_chunk_product_ref`.
    """
    C, k = ids.shape
    lp = N.shape[-1]
    M = torch.empty((C, k, lp), dtype=N.dtype, device=N.device)
    v = entry_f.unsqueeze(-1)
    for t in range(k):
        v = semiring_matmul_ref(class_tables(N, ids[:, t]), v)
        M[:, t] = v[..., 0]
    beta = entry_b.unsqueeze(-2)                      # row vector: βᵀ N = (Nᵀ β)ᵀ
    for t in range(k - 1, -1, -1):
        M[:, t] *= beta[:, 0]
        beta = semiring_matmul_ref(beta, class_tables(N, ids[:, t]))
    return M


def build_merge_packed_ref(
    N: torch.Tensor, ids: torch.Tensor, entry_f: torch.Tensor, entry_b: torch.Tensor
) -> torch.Tensor:
    """Packed form of :func:`build_merge_chunk_ref`: (C, k, ℓp/32) int32 words
    with the uint32 bit pattern of ``pack_bits`` along ℓp."""
    return pack_bits_torch(build_merge_chunk_ref(N, ids, entry_f, entry_b))


def packed_reach_chunk_product_ref(Np: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Packed chunk products of C chunks at once, on int32 words.

    Np (A+1, ℓp, W) packed transition rows (row ``k`` of ``Np[a]`` is the
    target set of source ``k``), or a tenant stack (T, A+1, ℓp, W); ids
    (C, k) → (C, ℓp, W), the packed
    identity folded through P'[j] = OR_k bit_k(P[j]) · Np[x_t][k].
    """
    C, k = ids.shape
    lp = Np.shape[-2]
    P = packed_identity(lp, Np.device).expand(C, lp, Np.shape[-1])
    return sparse_reach_rows_ref(Np, ids, P)


def sparse_reach_rows_ref(Np: torch.Tensor, ids: torch.Tensor, R0: torch.Tensor) -> torch.Tensor:
    """The same fold over S gathered rows per chunk, seeded from R0.

    Np (A+1, ℓp, W) or (T, A+1, ℓp, W), ids (C, k), R0 (C, S, W) int32 →
    (C, S, W).
    """
    R = R0.contiguous()
    for t in range(ids.shape[1]):
        R = packed_semiring_matmul(class_tables(Np, ids[:, t]), R)
    return R


def unpack_columns_ref(
    col0: torch.Tensor, cols: torch.Tensor, *, lengths: Sequence[int], ell: int
) -> Tuple[torch.Tensor, ...]:
    """Each text's (n+1, ℓ) bool forest columns from a bucket group's packed
    words: col0 (B, W), cols (B, c, k, W) int32, the first len(``lengths``)
    batch rows texts of those lengths.  Row 0 is C₀ and row r packed row
    r − 1; column j is bit j % 32 of word j // 32."""
    W = col0.shape[-1]
    j = torch.arange(ell, device=col0.device)
    word, shift = j // 32, (j % 32).to(torch.int32)
    out = []
    for b, n in enumerate(lengths):
        words = torch.cat((col0[b, None], cols[b].reshape(-1, W)[:n]))
        out.append(((words[:, word] >> shift) & 1).to(torch.bool))
    return tuple(out)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, window: Optional[int] = None, softcap: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention: q (b, L, h, hd), k and v (b, Lk, h, hd) with
    the KV heads already repeated to the query heads.  Scores and softmax in
    f32; a ``softcap`` c (None or 0: off) maps each scaled score s to
    c·tanh(s/c) before the mask; p is cast to v's dtype before the PV product
    (f32 accumulation); the output is in q's dtype."""
    L, hd = q.shape[1], q.shape[-1]
    Lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(L, device=q.device)[:, None]
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((L, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", _wide(p.to(v.dtype)), _wide(v)).to(q.dtype)


def ssd_chunk_ref(
    xdt: torch.Tensor, cs: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    S_prev: Optional[torch.Tensor], *, outputs: str = "both",
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """SSD intra-chunk output and state contribution per flattened program.

    xdt (P, q, hp), cs (P, q, 1) f32 cumulative decay logs, B and C (P, q, n),
    S_prev (P, hp, n) f32 → y = (L∘CBᵀ)·xdt + exp(cs)∘(C·S_prevᵀ) (P, q, hp)
    and S_c = (w∘B)ᵀ·xdt (P, n, hp), all in f32; L_ij = exp(cs_i − cs_j) for
    i ≥ j, w_j = exp(cs_last − cs_j).  ``outputs`` ``"y"`` or ``"state"``
    computes only that one (the other comes back as None), with the same
    operations as ``"both"``; ``"state"`` reads neither C nor S_prev, which
    may be None there.
    """
    if outputs not in ("both", "y", "state"):
        raise ValueError(f"ssd_chunk: outputs must be 'both', 'y' or 'state', got {outputs!r}")
    if S_prev is None and outputs != "state":
        raise ValueError(f"ssd_chunk: outputs={outputs!r} needs S_prev")
    q = xdt.shape[1]
    csq = cs[..., 0]
    Bf, xf = _wide(B), _wide(xdt)
    y = S_c = None
    if outputs != "state":
        iota = torch.arange(q, device=xdt.device)
        # the mask is taken before the exponential: exp(cs_i − cs_j) above the
        # diagonal may overflow, and its gradient (0 · inf) would be NaN
        Lmask = torch.exp(torch.where(iota[:, None] >= iota[None, :],
                                      csq[:, :, None] - csq[:, None, :], float("-inf")))
        Cf = _wide(C)
        CB = torch.einsum("pin,pjn->pij", Cf, Bf)
        y_intra = torch.einsum("pij,pjh->pih", Lmask * CB, xf)
        y_inter = torch.exp(csq)[..., None] * torch.einsum("pin,phn->pih", Cf, _wide(S_prev))
        y = y_intra + y_inter
    if outputs != "y":
        w = torch.exp(csq[:, -1:] - csq)
        S_c = torch.einsum("pqn,pqh->pnh", w[..., None] * Bf, xf)
    return y, S_c
