"""Host-side image utilities — behavior parity with the reference's
``src/flux/util.py:52-109`` (``c_crop``/``pad64``/``HWC3``/
``resize_image_with_pad``) and ``image_datasets/dataset_cc3m.py:66-88,124-166``
(``crop_to_aspect_ratio``, ``collate_anyres``).

These are numpy-first (our data layer feeds device-ready numpy batches, not
PIL/torch tensors); images are HWC uint8/float arrays.  ``collate_anyres``
produces the packed variable-resolution batch layout (packed tokens +
cu_seqlens + grid ids) the reference built for its VQModel path — here with
numpy outputs ready for ``torch.from_numpy`` and a flash-attention-style
cu_seqlens consumer.  Port of ``genhancer_tpu/data/image_utils.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def c_crop(image: np.ndarray) -> np.ndarray:
    """Center square crop of an HWC array (util.py:52-60)."""
    h, w = image.shape[:2]
    s = min(h, w)
    top = (h - s) // 2
    left = (w - s) // 2
    return image[top:top + s, left:left + s]


def pad64(x: int) -> int:
    """Padding needed to reach the next multiple of 64 (util.py:63-64)."""
    return int(np.ceil(float(x) / 64.0) * 64 - x)


def HWC3(x: np.ndarray) -> np.ndarray:
    """Normalize to 3-channel HWC uint8; alpha composites over white
    (util.py:67-82)."""
    assert x.dtype == np.uint8
    if x.ndim == 2:
        x = x[:, :, None]
    assert x.ndim == 3
    c = x.shape[2]
    assert c in (1, 3, 4)
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    color = x[:, :, 0:3].astype(np.float32)
    alpha = x[:, :, 3:4].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def resize_image_with_pad(input_image: np.ndarray, resolution: int,
                          skip_hwc3: bool = False, mode: str = "edge"):
    """Resize short side to ``resolution`` (area interpolation) and pad each
    side up to a multiple of 64; returns (padded, remove_pad) like
    util.py:91-109.  resolution=0 is a passthrough."""
    img = input_image if skip_hwc3 else HWC3(input_image)
    h_raw, w_raw = img.shape[:2]
    if resolution == 0:
        return img, lambda x: x
    k = float(resolution) / float(min(h_raw, w_raw))
    h_t, w_t = int(np.round(h_raw * k)), int(np.round(w_raw * k))
    img = _resize_area(img, h_t, w_t)
    img_padded = np.pad(img, [[0, pad64(h_t)], [0, pad64(w_t)], [0, 0]],
                        mode=mode)

    def remove_pad(x):
        return np.ascontiguousarray(x[:h_t, :w_t, ...])

    return np.ascontiguousarray(img_padded), remove_pad


def _resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area-style resize: OpenCV when present (reference used
    cv2.INTER_AREA), else PIL's box filter (equivalent for downscales)."""
    try:
        import cv2
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    except ImportError:
        from PIL import Image
        mode_img = Image.fromarray(img)
        return np.asarray(mode_img.resize((w, h), Image.BOX))


def crop_to_aspect_ratio(image: np.ndarray, ratio: str = "16:9") -> np.ndarray:
    """Center crop an HWC array to a named aspect ratio
    (dataset_cc3m.py:66-88)."""
    ratio_map = {"16:9": (16, 9), "4:3": (4, 3), "1:1": (1, 1)}
    tw, th = ratio_map[ratio]
    target = tw / th
    h, w = image.shape[:2]
    if w / h > target:
        new_w = int(h * target)
        off = (w - new_w) // 2
        return image[:, off:off + new_w]
    new_h = int(w / target)
    off = (h - new_h) // 2
    return image[off:off + new_h, :]


def collate_anyres(images: List[np.ndarray], sizes: Sequence[Tuple[int, int]],
                   patch_size: int, max_size: int = 2048):
    """Pack variable-resolution CHW images into one patch-token sequence.

    Parity with ``dataset_cc3m.py:124-166``: each image is split into
    ``patch_size``-square patches; valid patches of all images concatenate
    into ``packed`` [sum_i ph_i*pw_i, patch_size*patch_size*C] with
    ``cu_seqlens`` int32 [B+1] prefix offsets (flash-attention varlen
    convention), ``max_seqlen`` the longest single image, and ``grid_hw``
    the flattened (row * (max_size//patch_size) + col) position id per
    packed patch.

    Returns (packed, cu_seqlens, max_seqlen, grid_hw, image_sizes) as numpy.
    """
    b = len(images)
    c = images[0].shape[0]
    max_patch_num = max_size // patch_size

    image_sizes = np.asarray([(im.shape[1], im.shape[2]) for im in images],
                             np.int64)
    H, W = image_sizes.max(axis=0)
    padded = np.zeros((b, c, H, W), dtype=images[0].dtype)

    sizes = np.asarray(sizes, np.int64)
    h, w = sizes.max(axis=0)
    masks = np.zeros((b, h, w), dtype=bool)
    for i, (im, (ph, pw)) in enumerate(zip(images, sizes)):
        padded[i, :, :im.shape[1], :im.shape[2]] = im
        masks[i, :ph, :pw] = True

    # n c (h p) (w q) -> n h w (p q c)
    padded = padded.reshape(b, c, h, patch_size, w, patch_size)
    padded = np.einsum("nchpwq->nhwpqc", padded)
    padded = padded.reshape(b, h, w, -1)
    packed = padded[masks]

    seq_lens = masks.reshape(b, -1).sum(axis=-1).astype(np.int32)
    cu_seqlens = np.concatenate([[0], np.cumsum(seq_lens)]).astype(np.int32)
    max_seqlen = int(seq_lens.max())

    grid_h = np.broadcast_to(np.arange(h)[None, :, None], (b, h, w))
    grid_w = np.broadcast_to(np.arange(w)[None, None, :], (b, h, w))
    grid_hw = (grid_h * max_patch_num + grid_w)[masks]
    return packed, cu_seqlens, max_seqlen, grid_hw, sizes
