"""Host-side multimodal utilities: tokenization with X-token splicing,
image preprocessing helpers, anyres grid math, stop-keyword trimming.

A copy of ``videollamb_tpu/mm_utils.py`` (reference llava/mm_utils.py:
tokenizer_x_token :185-204, anyres helpers :13-150, expand2square :153,
process_images :167, KeywordsStoppingCriteria :236-268,
get_model_name_from_path :228), numpy / PIL based. The anyres grid
arithmetic is the reference's float64 ``int(...)`` rounding.
"""

from __future__ import annotations

import ast
import base64
import math
import re
from io import BytesIO
from typing import List, Optional, Sequence, Tuple

import numpy as np

from videollamb_torch.constants import (
    DEFAULT_X_TOKEN,
    IMAGE_TOKEN_INDEX,
    X_INDEX_TOKEN,
    X_TOKEN_INDEX,
)


def tokenizer_x_token(
    prompt: str,
    tokenizer,
    x_token_index: int,
    return_tensors: Optional[str] = None,
):
    """Split the prompt on the modality token (``<image>``/``<video>``) and
    splice the negative sentinel index between the tokenized chunks, keeping
    a single BOS at the front (reference mm_utils.py:185-204)."""
    tag = f"<{X_INDEX_TOKEN[x_token_index].lower()}>"
    prompt_chunks = [tokenizer(chunk).input_ids for chunk in prompt.split(tag)]

    def insert_separator(chunks, sep):
        return [ele for pair in zip(chunks, [sep] * len(chunks)) for ele in pair][:-1]

    input_ids: List[int] = []
    offset = 0
    if prompt_chunks and prompt_chunks[0] and prompt_chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    for chunk in insert_separator(prompt_chunks, [x_token_index] * (offset + 1)):
        input_ids.extend(chunk[offset:])

    if return_tensors is not None:
        if return_tensors == "np":
            return np.asarray(input_ids, dtype=np.int32)
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def tokenizer_multi_x_token(
    prompt: str,
    tokenizer,
    return_tensors: Optional[str] = None,
) -> Tuple[object, List[str]]:
    """Mixed-modality prompt tokenization: split on every modality tag
    (``<image>`` / ``<video>`` / ``<audio>``) in order of appearance and
    splice each tag's own sentinel index, keeping one BOS at the front. The
    k-th sentinel binds visual block k in the splice (``models/splice.py``).

    Returns (input_ids, modalities), ``modalities`` the tag names (e.g.
    ["VIDEO", "IMAGE"]) in prompt order."""
    pat = re.compile("(" + "|".join(re.escape(t) for t in DEFAULT_X_TOKEN.values()) + ")")
    parts = pat.split(prompt)
    texts, tags = parts[0::2], parts[1::2]
    tag_to_mod = {v: k for k, v in DEFAULT_X_TOKEN.items()}
    modalities = [tag_to_mod[t] for t in tags]

    tok_chunks = [tokenizer(c).input_ids for c in texts]
    input_ids: List[int] = []
    offset = 0
    if tok_chunks and tok_chunks[0] and tok_chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(tok_chunks[0][0])
    for i, chunk in enumerate(tok_chunks):
        input_ids.extend(chunk[offset:])
        if i < len(modalities):
            input_ids.append(X_TOKEN_INDEX[modalities[i]])

    if return_tensors is not None:
        if return_tensors == "np":
            return np.asarray(input_ids, dtype=np.int32), modalities
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids, modalities


def tokenizer_image_token(prompt, tokenizer, image_token_index=IMAGE_TOKEN_INDEX,
                          return_tensors=None):
    return tokenizer_x_token(prompt, tokenizer, image_token_index, return_tensors)


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


# ---------------------------------------------------------------------------
# Image preprocessing (PIL-level; the normalize/resize math lives in
# videollamb_torch.data.processing)
# ---------------------------------------------------------------------------


def load_image_from_base64(image: str):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img, background_color):
    """Pad a PIL image to square with the given background color
    (reference mm_utils.py:153-164)."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]):
    """Pick the anyres target resolution maximizing effective resolution and
    minimizing wasted area (reference mm_utils.py:13-42)."""
    original_width, original_height = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        dw, dh = int(original_width * scale), int(original_height * scale)
        effective = min(dw * dh, original_width * original_height)
        wasted = (width * height) - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best_fit = (width, height)
    return best_fit


def resize_and_pad_image(image, target_resolution: Tuple[int, int]):
    """Resize preserving aspect then center-pad to the target (reference
    mm_utils.py:45-73)."""
    from PIL import Image

    original_width, original_height = image.size
    target_width, target_height = target_resolution
    scale_w = target_width / original_width
    scale_h = target_height / original_height
    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.ceil(original_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.ceil(original_width * scale_h), target_width)
    resized = image.resize((new_width, new_height))
    new_image = Image.new("RGB", (target_width, target_height), (0, 0, 0))
    new_image.paste(resized, ((target_width - new_width) // 2,
                              (target_height - new_height) // 2))
    return new_image


def divide_to_patches(image, patch_size: int):
    """Divide a PIL image into patch_size x patch_size crops (reference
    mm_utils.py:76-97)."""
    patches = []
    width, height = image.size
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def unpad_image(tensor: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
    """Remove aspect-ratio padding from an anyres feature grid
    (reference llava_arch.py:222-250). tensor: (C, H, W); original_size
    (width, height) of the source image."""
    original_width, original_height = original_size
    current_height, current_width = tensor.shape[1:]
    original_aspect = original_width / original_height
    current_aspect = current_width / current_height
    if original_aspect > current_aspect:
        scale_factor = current_width / original_width
        new_height = int(original_height * scale_factor)
        padding = (current_height - new_height) // 2
        return tensor[:, padding: current_height - padding, :]
    scale_factor = current_height / original_height
    new_width = int(original_width * scale_factor)
    padding = (current_width - new_width) // 2
    return tensor[:, :, padding: current_width - padding]


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    possible = grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    width, height = select_best_resolution(image_size, possible)
    return width // patch_size, height // patch_size


def process_anyres_image(image, processor, grid_pinpoints) -> np.ndarray:
    """Anyres: resize+pad to the best grid, crop patches, prepend the
    globally-resized image, preprocess each (reference mm_utils.py:120-146)."""
    possible = grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    best_resolution = select_best_resolution(image.size, possible)
    image_padded = resize_and_pad_image(image, best_resolution)
    patches = divide_to_patches(image_padded, processor.crop_size)
    image_original_resize = image.resize((processor.shortest_edge, processor.shortest_edge))
    image_patches = [image_original_resize] + patches
    return np.stack([processor(p) for p in image_patches], axis=0)


def process_images(images, image_processor, model_cfg) -> np.ndarray:
    """Batch image preprocessing with 'pad'/'anyres'/default aspect handling
    (reference mm_utils.py:167-183)."""
    image_aspect_ratio = getattr(model_cfg, "image_aspect_ratio", None)
    if image_aspect_ratio == "pad":
        out = []
        for image in images:
            bg = tuple(int(x * 255) for x in image_processor.image_mean)
            out.append(image_processor(expand2square(image, bg)))
        return np.stack(out, axis=0)
    if image_aspect_ratio == "anyres":
        out = [process_anyres_image(im, image_processor, model_cfg.image_grid_pinpoints)
               for im in images]
        if all(x.shape == out[0].shape for x in out):
            return np.stack(out, axis=0)
        return out
    return np.stack([image_processor(im) for im in images], axis=0)


class KeywordStopper:
    """Host-side equivalent of the reference KeywordsStoppingCriteria
    (mm_utils.py:236-268): detect/trim stop keywords in decoded text."""

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids = []
        for keyword in keywords:
            ids = tokenizer(keyword).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)

    def stop_token_ids(self) -> List[int]:
        """Single-token keywords usable as extra EOS ids."""
        return [ids[0] for ids in self.keyword_ids if len(ids) == 1]

    def trim(self, text: str) -> str:
        for keyword in self.keywords:
            idx = text.find(keyword)
            if idx >= 0:
                text = text[:idx]
        return text.strip()
