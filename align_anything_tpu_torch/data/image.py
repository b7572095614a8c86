"""Image preprocessing + the text-image-to-text datasets and collators: the
port of the fixed-resolution part of ``align_anything_tpu/data/image.py``.

The host decodes and resizes (Pillow), rescales and normalizes with the
CLIP mean and std; the device does the patchify (``models/vision.py``).
Collators expand each ``<image>`` placeholder into ``num_patches`` copies of
the model's image token id (LLaVA processor semantics), so a row's length
is fixed per (text bucket, number of images).

``TI2TPromptOnlyDataset`` is the RL trainers' prompt set: each row holds
the prompt with its image expanded, and the image's pixels in ``meta``;
the text ``PromptOnlyCollator`` left-pads the rows.

``AnyResProcessor`` is LLaVA-Next's tiling: an image becomes its base crop
and the tiles of the best pinpoint resolution, padded to a fixed crop
count, with ``select_idx``, the gather that packs their features in HF's
order, and ``num_tokens``, the image's <image> expansion.

``MllamaTileProcessor`` is Mllama's aspect-ratio tiling: an image becomes
up to ``max_num_tiles`` tiles of the canvas that fits it best, with its
``aspect_ratio_ids`` and ``aspect_ratio_mask``, and one image token
(``num_tokens`` 1: the image reaches the text by cross-attention).

``Idefics2NaViTProcessor`` is Idefics2's variable aspect ratio: an image
resized between the shortest and longest edges becomes its patch rows,
packed into a fixed count of slots, with ``tgt_sizes``, its patch grid,
and the perceiver's latent count as its ``num_tokens``.

``MiniCPMVSliceProcessor`` is MiniCPM-V's slice mode: an image becomes
a source crop and up to ``max_slice_nums`` grid slices, each packed into a
fixed count of patch slots with its grid in ``tgt_sizes``, and
``num_tokens`` is the crop count times the resampler's query count.
"""

from __future__ import annotations

import dataclasses
import io
import math
from typing import Any, Sequence

import numpy as np

from align_anything_tpu_torch.data.chat_template import ChatTemplate
from align_anything_tpu_torch.data.datasets import (
    DEFAULT_BUCKETS,
    IGNORE_INDEX,
    PreferenceCollator,
    PreferenceDataset,
    PromptOnlyDataset,
    SupervisedDataset,
    _common_prefix_len,
)
from align_anything_tpu_torch.utils.tools import bucket_length

IMAGE_PLACEHOLDER = '<image>'

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    size: int = 224
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD


class ImageProcessor:
    """PIL image, array, path or bytes -> (C, H, W) float32: CLIP resize of
    the short side, center crop, normalize."""

    def __init__(self, config: ImageProcessorConfig = ImageProcessorConfig()):
        self.config = config

    def __call__(self, image: Any) -> np.ndarray:
        c = self.config
        arr = self._to_array(image)
        arr = self._resize_center_crop(arr, c.size)
        arr = arr.astype(np.float32) / 255.0
        mean = np.asarray(c.mean, np.float32)[:, None, None]
        std = np.asarray(c.std, np.float32)[:, None, None]
        return (arr.transpose(2, 0, 1) - mean) / std

    @staticmethod
    def _to_array(image: Any) -> np.ndarray:
        if isinstance(image, np.ndarray):
            arr = image
        elif hasattr(image, 'convert'):  # PIL
            arr = np.asarray(image.convert('RGB'))
        elif isinstance(image, (bytes, str)):
            from PIL import Image  # noqa: PLC0415

            img = (Image.open(io.BytesIO(image)) if isinstance(image, bytes)
                   else Image.open(image))
            arr = np.asarray(img.convert('RGB'))
        else:
            raise TypeError(f'unsupported image type: {type(image)}')
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr

    @staticmethod
    def _resize_center_crop(arr: np.ndarray, size: int) -> np.ndarray:
        h, w = arr.shape[:2]
        if (h, w) != (size, size):
            try:
                from PIL import Image  # noqa: PLC0415

                scale = size / min(h, w)
                nh, nw = round(h * scale), round(w * scale)
                img = Image.fromarray(arr).resize((nw, nh), Image.BICUBIC)
                arr = np.asarray(img)
            except ImportError:
                # without Pillow: a nearest-neighbour resample of the whole
                # image (no crop), as the JAX package does
                ys = np.linspace(0, h - 1, size).astype(int)
                xs = np.linspace(0, w - 1, size).astype(int)
                return arr[ys][:, xs]
            h, w = arr.shape[:2]
            top, left = (h - size) // 2, (w - size) // 2
            arr = arr[top:top + size, left:left + size]
        return arr


def select_best_resolution(original_size: tuple[int, int],
                           possible: Sequence[tuple[int, int]]
                           ) -> tuple[int, int]:
    """HF select_best_resolution (image_processing_utils.py:262): the
    (h, w) of ``possible`` with the largest effective resolution, ties
    broken by the least waste."""
    oh, ow = original_size
    best, best_eff, best_waste = None, 0, float('inf')
    for h, w in possible:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = h * w - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


class AnyResProcessor:
    """LLaVA-Next AnyRes tiling and packing geometry, on the host.

    An image -> ``{'pixel_values': (1 + max_tiles, 3, S, S) float32,
    'select_idx': (max_tokens,) int32, 'num_tokens': int}``: the base crop
    (the whole image resized to S x S) and the tiles of the image resized
    into the best pinpoint resolution and centered on it, zero crops after
    them; ``select_idx`` is HF's pack_image_features (the base crop's
    patches, then the tiles' grid in row-major order with the padding rows
    or columns cut away and ``image_newline`` after each row) as indices
    into the flattened crop features, ``num_crops * P`` selecting the
    newline, zeros after ``num_tokens``.  Every image gives the same
    shapes; ``num_tokens`` is how many <image> tokens its text holds."""

    dynamic = True

    def __init__(self, vcfg, grid_pinpoints: Sequence[tuple[int, int]]):
        self.size = vcfg.image_size                     # crop side (336)
        self.ph = vcfg.image_size // vcfg.patch_size    # feature side (24)
        self.pinpoints = [tuple(p) for p in grid_pinpoints]
        self.max_tiles = max((h // self.size) * (w // self.size)
                             for h, w in self.pinpoints)
        self.num_crops = 1 + self.max_tiles
        ph = self.ph
        self.max_tokens = ph * ph + max(
            (h // self.size) * ph * ((w // self.size) * ph + 1)
            for h, w in self.pinpoints)
        self.mean = np.asarray(CLIP_MEAN, np.float32)
        self.std = np.asarray(CLIP_STD, np.float32)

    @property
    def num_patches(self) -> int:
        """The most <image> tokens an image can take (bucket sizing)."""
        return self.max_tokens

    def _normalize(self, arr: np.ndarray) -> np.ndarray:
        x = arr.astype(np.float32) / 255.0
        return ((x - self.mean) / self.std).transpose(2, 0, 1)

    def __call__(self, image: Any) -> dict[str, Any]:
        from PIL import Image as PILImage  # noqa: PLC0415

        s, ph = self.size, self.ph
        arr = ImageProcessor._to_array(image)
        h, w = arr.shape[:2]
        bh, bw = select_best_resolution((h, w), self.pinpoints)
        # resize for patching (HF get_patch_output_size: ceil, clipped)
        scale_w, scale_h = bw / w, bh / h
        if scale_w < scale_h:
            nw, nh = bw, min(math.ceil(h * scale_w), bh)
        else:
            nh, nw = bh, min(math.ceil(w * scale_h), bw)
        resized = np.asarray(PILImage.fromarray(arr).resize(
            (nw, nh), PILImage.BICUBIC))
        # centered pad (divmod: the larger half goes after)
        py = (bh - nh) // 2
        px = (bw - nw) // 2
        canvas = np.zeros((bh, bw, 3), arr.dtype)
        canvas[py:py + nh, px:px + nw] = resized
        gh, gw = bh // s, bw // s
        tiles = canvas.reshape(gh, s, gw, s, 3).transpose(0, 2, 1, 3, 4)
        tiles = tiles.reshape(gh * gw, s, s, 3)
        base = np.asarray(PILImage.fromarray(arr).resize(
            (s, s), PILImage.BICUBIC))
        crops = np.zeros((self.num_crops, 3, s, s), np.float32)
        crops[0] = self._normalize(base)
        for i in range(gh * gw):
            crops[1 + i] = self._normalize(tiles[i])

        # packing geometry: the feature grid (R, C) with its padding rows
        # or columns cut away, centered (modeling_llava_next.py
        # unpad_image), row-major with a newline after each row
        r_all, c_all = gh * ph, gw * ph
        if w / h > c_all / r_all:
            new_r = int(round(h * (c_all / w), 7))
            pad = (r_all - new_r) // 2
            rows, cols = range(pad, r_all - pad), range(c_all)
        else:
            new_c = int(round(w * (r_all / h), 7))
            pad = (c_all - new_c) // 2
            rows, cols = range(r_all), range(pad, c_all - pad)
        p_per = ph * ph
        select = list(range(p_per))                     # the base crop
        newline_idx = self.num_crops * p_per
        for r in rows:
            for c in cols:
                tile = 1 + (r // ph) * gw + (c // ph)
                select.append(tile * p_per + (r % ph) * ph + (c % ph))
            select.append(newline_idx)
        num_tokens = len(select)
        out_sel = np.zeros((self.max_tokens,), np.int32)
        out_sel[:num_tokens] = select
        return {'pixel_values': crops, 'select_idx': out_sel,
                'num_tokens': num_tokens}


def ensure_divide(length: float, patch_size: int) -> int:
    """Round to the nearest multiple of ``patch_size``, at least one
    patch."""
    return max(round(length / patch_size) * patch_size, patch_size)


def find_best_resize(size_wh: tuple[int, int], scale_resolution: int,
                     patch_size: int,
                     allow_upscale: bool = False) -> tuple[int, int]:
    """MiniCPM-V's best (w, h): area about ``scale_resolution ** 2`` at the
    image's aspect (only downward unless ``allow_upscale``), both sides
    multiples of ``patch_size``."""
    w, h = size_wh
    if (w * h > scale_resolution * scale_resolution) or allow_upscale:
        r = w / h
        h = int(scale_resolution / math.sqrt(r))
        w = int(h * r)
    return ensure_divide(w, patch_size), ensure_divide(h, patch_size)


def get_sliced_grid(size_wh: tuple[int, int], max_slice_nums: int,
                    scale_resolution: int) -> tuple[int, int] | None:
    """(cols, rows) of MiniCPM-V's slicing grid, or None when the image
    fits one crop: the slice counts m - 1, m, m + 1 around m = ceil(area /
    scale ** 2) (never 1, never past ``max_slice_nums``), every
    factorization of each, the one nearest the image's aspect in log
    ratio (the first of equals)."""
    w, h = size_wh
    log_ratio = math.log(w / h)
    multiple = min(math.ceil(w * h / scale_resolution ** 2), max_slice_nums)
    if multiple <= 1:
        return None
    best, best_err = None, float('inf')
    for num in (multiple - 1, multiple, multiple + 1):
        if num == 1 or num > max_slice_nums:
            continue
        for m in range(1, num + 1):
            if num % m:
                continue
            err = abs(log_ratio - math.log(m / (num // m)))
            if err < best_err:
                best, best_err = (m, num // m), err
    return best


def get_refine_size(size_wh: tuple[int, int], grid: tuple[int, int],
                    scale_resolution: int,
                    patch_size: int) -> tuple[int, int]:
    """The (w, h) canvas whose grid cells each take ``find_best_resize``'s
    size, upscaled or not."""
    w, h = size_wh
    cols, rows = grid
    cell_w = ensure_divide(w, cols) / cols
    cell_h = ensure_divide(h, rows) / rows
    bw, bh = find_best_resize((cell_w, cell_h), scale_resolution,
                              patch_size, allow_upscale=True)
    return bw * cols, bh * rows


class MiniCPMVSliceProcessor:
    """MiniCPM-V's adaptive slicing (slice mode) on the host, as JAX's: a
    source crop resized to about ``scale_resolution ** 2`` (upscaled when
    the image fits one crop), then, when ``get_sliced_grid`` finds a grid,
    the refined canvas cut into its cells, row by row; every resize Pillow
    BICUBIC.  Each crop is normalized with the 0.5 / 0.5 mean and std and
    packed row-major, each patch flattened channel-major as the conv's
    OIHW kernel; a crop with a side past ``max_grid_side`` patches is
    resized down to it first.  A crop's patches past ``max_patches`` are
    cut, but its ``tgt_sizes`` keeps the whole grid, as JAX's does.

    Returns ``{'pixel_values': (1 + max_slice_nums, max_patches, 3*p*p),
    'tgt_sizes': (1 + max_slice_nums, 2) the (h, w) grids, zero for unused
    crops, 'num_tokens': n_crops * query_num}``: the resampler turns every
    crop into ``query_num`` tokens."""

    dynamic = True

    def __init__(self, vcfg, query_num: int = 64,
                 scale_resolution: int = 448, max_slice_nums: int = 9,
                 max_grid_side: int | None = None):
        self.patch_size = vcfg.patch_size
        self.query_num = query_num
        self.scale_resolution = scale_resolution
        self.max_slice_nums = max_slice_nums
        self.num_crops = 1 + max_slice_nums
        # the resampler's sincos table is (max_size, max_size): a wider
        # grid is resized down to it
        self.max_grid_side = max_grid_side
        side_cap = (max_grid_side if max_grid_side is not None
                    else scale_resolution // vcfg.patch_size + 1)
        self.max_patches = min((scale_resolution // vcfg.patch_size + 1)
                               ** 2, side_cap * side_cap)

    @property
    def num_patches(self) -> int:
        """The most image tokens an image expands to."""
        return self.num_crops * self.query_num

    def _pack(self, arr: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """(H, W, 3) uint8 -> ((h*w, 3*p*p) float32, (h, w))."""
        p = self.patch_size
        cap = self.max_grid_side
        if cap is not None and max(arr.shape[:2]) > cap * p:
            from PIL import Image as PILImage  # noqa: PLC0415

            nh = min(arr.shape[0], cap * p)
            nw = min(arr.shape[1], cap * p)
            nh, nw = ensure_divide(nh, p), ensure_divide(nw, p)
            arr = np.asarray(PILImage.fromarray(arr).resize(
                (nw, nh), PILImage.BICUBIC))
        x = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
        hg, wg = arr.shape[0] // p, arr.shape[1] // p
        x = x.transpose(2, 0, 1).reshape(3, hg, p, wg, p)
        return (x.transpose(1, 3, 0, 2, 4).reshape(hg * wg, 3 * p * p),
                (hg, wg))

    def __call__(self, image: Any) -> dict[str, Any]:
        from PIL import Image as PILImage  # noqa: PLC0415

        arr = ImageProcessor._to_array(image)
        h, w = arr.shape[:2]
        img = PILImage.fromarray(arr)
        grid = get_sliced_grid((w, h), self.max_slice_nums,
                               self.scale_resolution)
        bw, bh = find_best_resize((w, h), self.scale_resolution,
                                  self.patch_size,
                                  allow_upscale=grid is None)
        crops = [np.asarray(img.resize((bw, bh), PILImage.BICUBIC))]
        if grid is not None:
            rw, rh = get_refine_size((w, h), grid, self.scale_resolution,
                                     self.patch_size)
            refined = np.asarray(img.resize((rw, rh), PILImage.BICUBIC))
            cols, rows = grid
            cw, ch = rw // cols, rh // rows
            crops += [refined[i * ch:(i + 1) * ch, j * cw:(j + 1) * cw]
                      for i in range(rows) for j in range(cols)]
        pixel = np.zeros((self.num_crops, self.max_patches,
                          3 * self.patch_size ** 2), np.float32)
        tgt = np.zeros((self.num_crops, 2), np.int32)
        for i, crop in enumerate(crops):
            patches, (hg, wg) = self._pack(crop)
            n = min(patches.shape[0], self.max_patches)
            pixel[i, :n] = patches[:n]
            tgt[i] = (hg, wg)
        return {'pixel_values': pixel, 'tgt_sizes': tgt,
                'num_tokens': len(crops) * self.query_num}


class Idefics2NaViTProcessor:
    """Idefics2's variable-aspect preprocessing (NaViT) on the host, as
    JAX's: resize so the longest edge is at most ``longest_edge`` (the
    tower's image size by default) and the shortest at least
    ``shortest_edge``, keeping the aspect, both rounded to patch multiples
    (``ensure_divide``) and clamped to the square grid; normalize with the
    0.5 / 0.5 mean and std; pack the patches row-major, each flattened
    channel-major as the conv's OIHW kernel.

    Returns ``{'pixel_values': (max_patches, 3*p*p), 'tgt_sizes': (2,)
    the (h, w) patch grid, 'num_tokens': n_latents}``: the perceiver
    compresses any grid to ``n_latents`` tokens."""

    dynamic = True

    def __init__(self, vcfg, n_latents: int = 64,
                 shortest_edge: int = 378, longest_edge: int | None = None):
        self.patch_size = vcfg.patch_size
        self.longest = longest_edge or vcfg.image_size
        self.shortest = min(shortest_edge, self.longest)
        self.n_latents = n_latents
        self.max_patches = (self.longest // vcfg.patch_size) ** 2
        self.mean = np.full((3,), 0.5, np.float32)
        self.std = np.full((3,), 0.5, np.float32)

    @property
    def num_patches(self) -> int:
        return self.n_latents

    def _target_size(self, h: int, w: int) -> tuple[int, int]:
        if w >= h and w > self.longest:
            h, w = int(self.longest * h / w), self.longest
        elif h > w and h > self.longest:
            h, w = self.longest, int(self.longest * w / h)
        h, w = max(h, self.shortest), max(w, self.shortest)
        p = self.patch_size
        clamp = (self.longest // p) * p
        return (min(ensure_divide(h, p), clamp),
                min(ensure_divide(w, p), clamp))

    def __call__(self, image: Any) -> dict[str, Any]:
        from PIL import Image as PILImage  # noqa: PLC0415

        p = self.patch_size
        arr = ImageProcessor._to_array(image)
        th, tw = self._target_size(*arr.shape[:2])
        arr = np.asarray(PILImage.fromarray(arr).resize(
            (tw, th), PILImage.BILINEAR))
        x = (arr.astype(np.float32) / 255.0 - self.mean) / self.std
        hg, wg = th // p, tw // p
        x = x.transpose(2, 0, 1).reshape(3, hg, p, wg, p)
        patches = x.transpose(1, 3, 0, 2, 4).reshape(hg * wg, 3 * p * p)
        pixel = np.zeros((self.max_patches, 3 * p * p), np.float32)
        pixel[:patches.shape[0]] = patches
        return {'pixel_values': pixel,
                'tgt_sizes': np.asarray([hg, wg], np.int32),
                'num_tokens': self.n_latents}


class MllamaTileProcessor:
    """Mllama's aspect-ratio tiling on the host (HF
    image_processing_mllama.py semantics): the optimal tile canvas among
    the supported ratios, resize-to-fit and pad, the tiles, normalized
    with the 0.5 / 0.5 mean and std.

    Returns ``{'pixel_values': (1, max_tiles, 3, ts, ts),
    'aspect_ratio_ids': (1,), 'aspect_ratio_mask': (1, max_tiles),
    'num_tokens': 1}``: one ``<image>`` token an image, which reaches the
    text through the cross-attention layers, not by an embedding merge."""

    dynamic = True

    def __init__(self, vcfg):
        self.tile_size = vcfg.image_size
        self.max_tiles = vcfg.max_num_tiles
        # (h_tiles, w_tiles) in HF's id order: the first coordinate outer
        self.ratios = [(a, b) for a in range(1, self.max_tiles + 1)
                       for b in range(1, self.max_tiles + 1)
                       if a * b <= self.max_tiles]

    def _optimal_canvas(self, h: int, w: int) -> tuple[int, int]:
        ts = self.tile_size
        sizes = np.asarray(self.ratios) * ts
        scales = np.minimum(sizes[:, 0] / h, sizes[:, 1] / w)
        up = scales[scales >= 1]
        sel = up.min() if len(up) else scales[scales < 1].max()
        cand = sizes[scales == sel]
        return tuple(cand[np.argmin(cand[:, 0] * cand[:, 1])])

    def __call__(self, image: Any) -> dict[str, Any]:
        from PIL import Image as PILImage  # noqa: PLC0415

        ts = self.tile_size
        arr = ImageProcessor._to_array(image)
        h, w = arr.shape[:2]
        ch, cw = self._optimal_canvas(h, w)
        # fit to the canvas, keeping the aspect (image_processing_mllama.py:82)
        th, tw = np.clip(h, ts, ch), np.clip(w, ts, cw)
        scale_h, scale_w = th / h, tw / w
        if scale_w < scale_h:
            nh, nw = min(int(h * scale_w) or 1, th), tw
        else:
            nh, nw = th, min(int(w * scale_h) or 1, tw)
        arr = np.asarray(PILImage.fromarray(arr).resize(
            (int(nw), int(nh)), PILImage.BILINEAR))       # HF's default
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:nh, :nw] = arr.astype(np.float32)
        x = canvas / 255.0
        x = ((x - 0.5) / 0.5).transpose(2, 0, 1)          # (3, ch, cw)
        nth, ntw = ch // ts, cw // ts
        tiles = x.reshape(3, nth, ts, ntw, ts).transpose(1, 3, 0, 2, 4)
        tiles = tiles.reshape(nth * ntw, 3, ts, ts)
        out = np.zeros((self.max_tiles, 3, ts, ts), np.float32)
        out[:tiles.shape[0]] = tiles
        mask = np.zeros((self.max_tiles,), np.int32)
        mask[:tiles.shape[0]] = 1
        ar_id = self.ratios.index((nth, ntw)) + 1
        return {
            'pixel_values': out[None],                    # the media axis
            'aspect_ratio_ids': np.asarray([ar_id], np.int32),
            'aspect_ratio_mask': mask[None],
            'num_tokens': 1,
        }


def expand_image_tokens(text: str, tokenizer, image_token_id: int,
                        num_patches: int) -> list[int]:
    """Tokenize ``text`` with each <image> replaced by ``num_patches``
    image-token ids (LlavaProcessor expansion semantics)."""
    parts = text.split(IMAGE_PLACEHOLDER)
    ids: list[int] = []
    for i, part in enumerate(parts):
        if i > 0:
            ids.extend([image_token_id] * num_patches)
        if part:
            out = tokenizer(part, add_special_tokens=(i == 0))
            part_ids = out['input_ids'] if isinstance(out, dict) else out.input_ids
            # strip a trailing eos on non-final segments and a leading bos
            # on all but the first
            if (i + 1 < len(parts) and part_ids
                    and part_ids[-1] == tokenizer.eos_token_id):
                part_ids = part_ids[:-1]
            if i > 0 and part_ids and part_ids[0] == getattr(
                    tokenizer, 'bos_token_id', None):
                part_ids = part_ids[1:]
            ids.extend(part_ids)
    return ids


class TI2TMixin:
    """Shared image plumbing for the TI2T dataset variants."""

    def _setup_mm(self, image_token_id: int, num_patches: int,
                  image_processor: ImageProcessor | None):
        self.image_token_id = image_token_id
        self.num_patches = num_patches
        self.image_processor = image_processor or ImageProcessor()

    def _encode_mm(self, text: str, n_tokens: int | None = None) -> list[int]:
        return expand_image_tokens(text, self.tokenizer, self.image_token_id,
                                   n_tokens or self.num_patches)

    def _process_image(self, image):
        """Run the image processor first: a processor that returns a dict
        decides how many <image> placeholders the text expands to
        (``num_tokens``)."""
        if image is None:
            return None, None
        out = self.image_processor(image)
        if isinstance(out, dict):
            return out, int(out['num_tokens'])
        return out, None


class TI2TSupervisedDataset(TI2TMixin, SupervisedDataset):
    """(reference: datasets/text_image_to_text/supervised.py:157-207)"""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        super().__init__(path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, full_text, mm = self.template.format_supervised_sample(
            self.raw[idx])
        pixel, n_tok = self._process_image(mm.get('image'))
        full_ids = self._encode_mm(full_text, n_tok)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text, n_tok)
        prompt_len = min(_common_prefix_len(prompt_ids, full_ids),
                         len(full_ids) - 1)
        labels = [IGNORE_INDEX] * prompt_len + full_ids[prompt_len:]
        # image tokens never contribute to the LM loss
        labels = [IGNORE_INDEX if t == self.image_token_id else lab
                  for t, lab in zip(full_ids, labels)]
        return {'input_ids': full_ids, 'labels': labels,
                'prompt_len': prompt_len, 'pixel_values': pixel}

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TI2TSupervisedCollator':
        return TI2TSupervisedCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


def _stack_pixels(pixels: list) -> dict[str, np.ndarray]:
    """Stack per-sample processor outputs: arrays (fixed resolution) or
    dicts of named arrays; every key except the host-side ``num_tokens`` is
    batched, and a row without an image gets zeros."""
    first = next(p for p in pixels if p is not None)
    if isinstance(first, dict):
        zero = {k: np.asarray(v) * 0 for k, v in first.items()
                if k != 'num_tokens'}
        rows = [p if p is not None else zero for p in pixels]
        return {
            k: np.stack([np.asarray(r[k]) for r in rows]).astype(
                np.float32 if k == 'pixel_values' else np.int32)
            for k in zero
        }
    zero = first * 0
    return {'pixel_values': np.stack(
        [p if p is not None else zero for p in pixels]).astype(np.float32)}


class TI2TSupervisedCollator:
    def __init__(self, pad_token_id: int, buckets=DEFAULT_BUCKETS,
                 pad_to=None):
        self.pad_token_id = pad_token_id
        self.buckets = buckets
        self.pad_to = pad_to

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        max_len = max(len(s['input_ids']) for s in samples)
        length = self.pad_to or bucket_length(max_len, self.buckets)
        b = len(samples)
        input_ids = np.full((b, length), self.pad_token_id, np.int32)
        labels = np.full((b, length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, length), np.int32)
        pixels = []
        for i, s in enumerate(samples):
            ids = np.asarray(s['input_ids'][:length], np.int32)
            lab = np.asarray(s['labels'][:length], np.int32)
            input_ids[i, :len(ids)] = ids
            labels[i, :len(lab)] = lab
            mask[i, :len(ids)] = 1
            pixels.append(s['pixel_values'])
        batch = {'input_ids': input_ids, 'labels': labels,
                 'attention_mask': mask}
        if any(p is not None for p in pixels):
            batch.update(_stack_pixels(pixels))
        return batch


class TI2TPreferenceDataset(TI2TMixin, PreferenceDataset):
    """(reference: datasets/text_image_to_text/preference.py)"""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        super().__init__(path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        prompt_text, better_text, worse_text, mm = (
            self.template.format_preference_with_prompt(self.raw[idx]))
        pixel, n_tok = self._process_image(mm.get('image'))
        better_ids = self._encode_mm(better_text, n_tok)[:self.max_length]
        worse_ids = self._encode_mm(worse_text, n_tok)[:self.max_length]
        prompt_ids = self._encode_mm(prompt_text, n_tok)
        return {
            'better_input_ids': better_ids,
            'worse_input_ids': worse_ids,
            'better_prompt_len': min(_common_prefix_len(prompt_ids, better_ids),
                                     len(better_ids) - 1),
            'worse_prompt_len': min(_common_prefix_len(prompt_ids, worse_ids),
                                    len(worse_ids) - 1),
            'pixel_values': pixel,
        }

    def get_collator(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                     pad_to: int | None = None) -> 'TI2TPreferenceCollator':
        return TI2TPreferenceCollator(self.tokenizer.pad_token_id, buckets,
                                      pad_to)


class TI2TPreferenceCollator:
    """The text preference collator, with pixel_values duplicated
    [better; worse]."""

    def __init__(self, pad_token_id: int, buckets=DEFAULT_BUCKETS,
                 pad_to=None):
        self.inner = PreferenceCollator(pad_token_id, buckets, pad_to)

    def __call__(self, samples: list[dict]) -> dict[str, np.ndarray]:
        batch = self.inner(samples)
        pixels = [s['pixel_values'] for s in samples]
        if any(p is not None for p in pixels):
            stacked = _stack_pixels(pixels)
            # rows are [better x B; worse x B]: the same image for both
            for key, arr in stacked.items():
                batch[key] = np.concatenate([arr, arr])
        return batch


class TI2TPromptOnlyDataset(TI2TMixin, PromptOnlyDataset):
    """Deduplicated image prompts for the RL trainers (JAX
    ``data/image.py`` ``TI2TPromptOnlyDataset``): a row's ``input_ids`` are
    the prompt with each <image> expanded to the image's tokens and no
    trailing EOS; its ``meta`` is ``{'pixel_values': (C, H, W)}``, or the
    template's mm-info where the row has no image.  Prompts are
    deduplicated by their text, as the text set does, so two rows that ask
    the same question of different images keep the first."""

    def __init__(self, path: str, template: ChatTemplate, tokenizer,
                 image_token_id: int, num_patches: int,
                 image_processor: ImageProcessor | None = None, **kw):
        PromptOnlyDataset.__init__(self, path, template, tokenizer, **kw)
        self._setup_mm(image_token_id, num_patches, image_processor)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        s = self.samples[idx]
        meta = dict(s['meta'])
        pixel, n_tok = self._process_image(meta.get('image'))
        ids = self._encode_mm(s['prompt_text'], n_tok)[:self.max_length]
        if ids and ids[-1] == self.tokenizer.eos_token_id:
            ids = ids[:-1]
        if pixel is not None:
            meta = {'pixel_values': pixel}
        return {'input_ids': ids, 'meta': meta}
