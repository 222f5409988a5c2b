"""Fused sparse-alignment evaluate: CUDA kernel 3, with its plain version.

Counterpart of ``svo_pro_universal_tpu/ops/pallas_align.py``
(``fused_evaluate`` :126-179, kernel :47-123). Source: ``csrc/align.cu``,
whose header notes what bounds it on Hopper and how its deterministic
two-pass reduction works. On the TPU this kernel is opt-in; the port's
sparse alignment always evaluates through it on the card.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from svo_pro_universal_tpu_torch.ops import _cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

FUSED_EVALUATE = _cuda.register(_cuda.Kernel(
    "fused_evaluate", "align.cu", "svo_fused_evaluate",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "svo_pro_universal_tpu/ops/pallas_align.py:126"))

_FEAT_PER_BLOCK = 8
_N_OUT = 74


def fused_evaluate_plain(tiles: torch.Tensor, ty: torch.Tensor,
                         tx: torch.Tensor, weight: torch.Tensor,
                         ref_patch: torch.Tensor, jac: torch.Tensor,
                         ab: torch.Tensor, patch_size: int = 4):
    """The Pallas kernel's arithmetic in tensor ops: the patch is sampled
    with one-hot row/column weight matrices (a tap outside the tile matches
    no row or column and contributes nothing), then
    H = Σ w·JᵀJ, g = −Σ w·Jᵀr, chi2 = Σ w·r², n = Σ w."""
    n, R, T = tiles.shape
    P = patch_size
    dev = tiles.device
    alpha, beta = ab[0], ab[1]
    y0f = torch.floor(ty)
    x0f = torch.floor(tx)
    fy = (ty - y0f)[:, None, None]
    fx = (tx - x0f)[:, None, None]
    ip = torch.arange(P, device=dev)[None, :, None]
    dr = (torch.arange(R, device=dev)[None, None, :]
          - y0f.long()[:, None, None] - ip)
    RowW = (torch.where(dr == 0, 1.0 - fy, 0.0)
            + torch.where(dr == 1, fy, 0.0))                   # [N, P, R]
    dc = (torch.arange(T, device=dev)[None, None, :]
          - x0f.long()[:, None, None] - ip)
    ColW = (torch.where(dc == 0, 1.0 - fx, 0.0)
            + torch.where(dc == 1, fx, 0.0))                   # [N, P, T]
    tmp = torch.bmm(RowW, tiles)                               # [N, P, T]
    cur = torch.bmm(tmp, ColW.transpose(1, 2)).reshape(n, P * P)
    res = cur * (1.0 + alpha) + beta - ref_patch
    w = weight[:, None]
    Jw = jac * w[..., None]
    H = torch.einsum("npi,npj->ij", Jw, jac)
    g = -torch.einsum("npi,np->i", Jw, res)
    chi2 = torch.sum(res * w * res)
    return H, g, chi2, torch.sum(weight)


def fused_evaluate(tiles: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                   weight: torch.Tensor, ref_patch: torch.Tensor,
                   jac: torch.Tensor, ab: torch.Tensor, patch_size: int = 4):
    """One evaluate over all features (kernel 3).

    tiles [N, R, T] f32; ty, tx [N] tile-local coords of patch pixel (0,0);
    weight [N] 0/1; ref_patch [N, P²]; jac [N, P², 8]; ab [2] = (α, β) on
    the tiles' device. Returns (H [8,8], g [8], chi2, n_visible) tensors.
    """
    n, R, T = tiles.shape
    P = patch_size
    area = P * P
    if (ty.shape != (n,) or tx.shape != (n,) or weight.shape != (n,)
            or ref_patch.shape != (n, area) or jac.shape != (n, area, 8)
            or ab.shape != (2,)):
        raise ValueError("fused_evaluate: inconsistent shapes")
    if tiles.device.type == "cpu":
        return fused_evaluate_plain(tiles, ty, tx, weight, ref_patch, jac,
                                    ab, P)
    if tiles.device.type != "cuda":
        raise ValueError(f"fused_evaluate: unsupported device {tiles.device}")
    if area > 64:
        raise ValueError(f"fused_evaluate: patch_size {P} > 8")
    args = [t.to(torch.float32).contiguous()
            for t in (tiles, ty, tx, weight, ref_patch, jac, ab)]
    _cuda.check_cuda("fused_evaluate", *args)
    nblocks = -(-n // _FEAT_PER_BLOCK)
    partials = torch.empty((max(nblocks, 1), _N_OUT), dtype=torch.float32,
                           device=tiles.device)
    out = torch.empty((_N_OUT,), dtype=torch.float32, device=tiles.device)
    Pt = _cuda.ptr
    FUSED_EVALUATE.launch(*[Pt(a) for a in args], Pt(partials), Pt(out),
                          n, R, T, P)
    return out[:64].view(8, 8), out[64:72], out[72], out[73]
