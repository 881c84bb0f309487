"""Anyres multi-patch feature merge.

Port of ``videollamb_tpu/models/anyres.py`` (reference
llava/model/llava_arch.py:265-331, the 'spatial' / 'spatial_unpad' / 'flat'
patch merge of encode_images, and :222-250 unpad_image).

The reference merges a variable number of per-patch feature grids into one
ragged token stream per image. Here the merge is one static-shape scatter,
so it needs no host sync on the card:

- the (NPH, NPW) grid and the unpad crop are data, a small int spec
  computed on the host in float64 (the reference's
  ``int(original_height * scale_factor)``);
- every patch token computes its output slot by index arithmetic; tokens
  cropped by unpad (or past the sample's real grid) go to a spill row past
  the end, which is dropped;
- newline tokens land in the end-of-row slots;
- the result is (N_max, D) plus a validity mask, which feeds the
  K-sentinel splice (``models/splice.py``) directly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from videollamb_torch.mm_utils import select_best_resolution


def anyres_spec(
    image_size: Tuple[int, int],
    grid_pinpoints: Sequence[Tuple[int, int]],
    vision_image_size: int,
    patches_per_side: int,
) -> np.ndarray:
    """Host-side: (NPH, NPW, pad_r, pad_c) int32 for one image.

    NPH / NPW from the best pinpoint resolution (reference mm_utils.py:105-117
    get_anyres_image_grid_shape); pad_r / pad_c are the unpad_image crop
    margins on the token grid (llava_arch.py:222-250), in the reference's
    float64 arithmetic, so the kept-row count matches its
    ``int(original_height * scale_factor)`` exactly.
    """
    orig_w, orig_h = image_size
    best_w, best_h = select_best_resolution(image_size, grid_pinpoints)
    npw = best_w // vision_image_size
    nph = best_h // vision_image_size
    h_grid = nph * patches_per_side
    w_grid = npw * patches_per_side
    pad_r = pad_c = 0
    original_aspect = orig_w / orig_h
    current_aspect = w_grid / h_grid
    if original_aspect > current_aspect:
        scale_factor = w_grid / orig_w
        new_height = int(orig_h * scale_factor)
        pad_r = (h_grid - new_height) // 2
    else:
        scale_factor = h_grid / orig_h
        new_width = int(orig_w * scale_factor)
        pad_c = (w_grid - new_width) // 2
    return np.array([nph, npw, pad_r, pad_c], np.int32)


def anyres_max_tokens(num_patches: int, patches_per_side: int, merge_type: str) -> int:
    """Static output length for a P-patch stack (P counts the base image)."""
    hw = patches_per_side * patches_per_side
    if merge_type in ("flat", "spatial"):
        return num_patches * hw
    if merge_type == "spatial_unpad":
        # base + full grid + one newline per (worst-case) grid row.
        return num_patches * hw + (num_patches - 1) * patches_per_side
    raise ValueError(f"Unexpected mm_patch_merge_type: {merge_type}")


def anyres_merge(
    patch_tokens: torch.Tensor,  # (P, hw, D): [base, patch_0, ..., patch_{P-2}]
    spec: torch.Tensor,          # (4,) int: nph, npw, pad_r, pad_c
    newline: torch.Tensor,       # (D,) learned image_newline
    patches_per_side: int,
    merge_type: str = "spatial_unpad",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-patch projected features -> (N_max, D) tokens + mask.

    - 'flat' (llava_arch.py:283): all patches flattened in patch order;
    - 'spatial' (:307-309): base first, then the patch grid in raster order
      over the (NPH*h, NPW*w) token grid;
    - 'spatial_unpad' (:297-306): like 'spatial', the grid cropped by the
      unpad margins and every kept row ended by ``newline``.
    """
    p, hw, d = patch_tokens.shape
    h = w = patches_per_side
    assert hw == h * w, (hw, h, w)
    n_max = anyres_max_tokens(p, patches_per_side, merge_type)
    dev = patch_tokens.device
    if merge_type == "flat":
        return patch_tokens.reshape(n_max, d), torch.ones(n_max, dtype=torch.bool, device=dev)

    spec = spec.to(device=dev, dtype=torch.long)
    nph, npw, pad_r, pad_c = spec[0], spec[1], spec[2], spec[3]
    grid_h, grid_w = nph * h, npw * w

    # Token-grid coordinates of every spatial-patch token.
    p_idx = torch.arange(p - 1, device=dev)
    npw1 = npw.clamp(min=1)
    ph, pw = p_idx // npw1, p_idx % npw1
    r = torch.arange(h, device=dev)
    c = torch.arange(w, device=dev)
    big_r = ph[:, None, None] * h + r[None, :, None]  # (P-1, h, 1)
    big_c = pw[:, None, None] * w + c[None, None, :]  # (P-1, 1, w)
    in_grid = (p_idx < nph * npw)[:, None, None]

    # One spill row past n_max takes every dropped token.
    buf = patch_tokens.new_zeros((n_max + 1, d))
    src = [patch_tokens[0]]  # base features first (:311)
    idx = [torch.arange(hw, device=dev)]
    if merge_type == "spatial":
        ok = in_grid.expand(p - 1, h, w)
        out_idx = hw + big_r * grid_w + big_c
        total = hw + nph * npw * hw
    else:  # spatial_unpad
        keep_h = grid_h - 2 * pad_r
        keep_w = grid_w - 2 * pad_c
        row_ok = (big_r >= pad_r) & (big_r < grid_h - pad_r)
        col_ok = (big_c >= pad_c) & (big_c < grid_w - pad_c)
        ok = in_grid & row_ok & col_ok
        out_idx = hw + (big_r - pad_r) * (keep_w + 1) + (big_c - pad_c)
        rows = torch.arange((p - 1) * h, device=dev)
        nl_idx = torch.where(rows < keep_h, hw + rows * (keep_w + 1) + keep_w, n_max)
        src.append(newline.to(patch_tokens.dtype).expand(rows.shape[0], d))
        idx.append(nl_idx)
        total = hw + keep_h * (keep_w + 1)
    out_idx = torch.where(ok, out_idx, n_max)
    src.append(patch_tokens[1:].reshape(-1, d))
    idx.append(out_idx.reshape(-1))
    # Kept slots are unique and written once; only the spill row repeats.
    buf = buf.index_copy(0, torch.cat(idx), torch.cat(src))[:n_max]
    mask = torch.arange(n_max, device=dev) < total
    return buf, mask
