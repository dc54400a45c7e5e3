"""DA3 input processor: image loading/resizing to /14-divisible targets, a
copy of ``videogpa_tpu/data/input_processor.py``.

Parity target: reference ``depth_anything_3/utils/io/input_processor.py`` —
four resize methods (upper/lower-bound boundary resize x crop/resize
divisibility snap), intrinsics rescale/crop tracking, parallel image loading,
ImageNet normalization. The reference's inline self-test assertions
(``:391-460``) are covered in ``tests/test_aux.py`` and ``tests/test_torch_da3_export.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Optional, Sequence, Tuple

import numpy as np

PATCH = 14
METHODS = (
    "upper_bound_resize",
    "upper_bound_crop",
    "lower_bound_resize",
    "lower_bound_crop",
)

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _nearest_multiple(x: int, p: int) -> int:
    down = (x // p) * p
    up = down + p
    return up if abs(up - x) <= abs(x - down) else max(down, p)


def _resize(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    import cv2

    upscale = new_w > img.shape[1] or new_h > img.shape[0]
    interp = cv2.INTER_CUBIC if upscale else cv2.INTER_AREA
    return cv2.resize(img, (new_w, new_h), interpolation=interp)


def process_one(
    img: np.ndarray,
    target_size: int = 518,
    method: str = "upper_bound_resize",
    K: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(H, W, 3) uint8 -> (3, H', W') normalized float32, adjusted intrinsics.

    H', W' are /14-divisible; scaling/cropping is tracked into K.
    """
    if method not in METHODS:
        raise ValueError(f"Unsupported resize method: {method}")
    h, w = img.shape[:2]
    K = None if K is None else K.astype(np.float64).copy()

    # 1) boundary resize preserving aspect
    bound = max(w, h) if method.startswith("upper") else min(w, h)
    if bound != target_size:
        scale = target_size / float(bound)
        new_w = max(1, round(w * scale))
        new_h = max(1, round(h * scale))
        if K is not None:
            K[0] *= new_w / w
            K[1] *= new_h / h
        img = _resize(img, new_w, new_h)
        h, w = img.shape[:2]

    # 2) make /14-divisible
    if method.endswith("crop"):
        new_w, new_h = (w // PATCH) * PATCH, (h // PATCH) * PATCH
        new_w, new_h = max(new_w, PATCH), max(new_h, PATCH)
        left, top = (w - new_w) // 2, (h - new_h) // 2
        img = img[top : top + new_h, left : left + new_w]
        if K is not None:
            K[0, 2] -= left
            K[1, 2] -= top
    else:
        new_w = _nearest_multiple(w, PATCH)
        new_h = _nearest_multiple(h, PATCH)
        if (new_w, new_h) != (w, h):
            if K is not None:
                K[0] *= new_w / w
                K[1] *= new_h / h
            img = _resize(img, new_w, new_h)

    assert img.shape[0] % PATCH == 0 and img.shape[1] % PATCH == 0
    out = (img.astype(np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD
    return out.transpose(2, 0, 1), (None if K is None else K.astype(np.float32))


class InputProcessor:
    """Batch image preprocessing with thread parallelism."""

    def __init__(self, num_workers: int = 8):
        self.num_workers = num_workers

    def __call__(
        self,
        images: Sequence,
        target_size: int = 518,
        process_res_method: str = "upper_bound_resize",
        intrinsics: Optional[Sequence[np.ndarray]] = None,
    ):
        """images: list of (H, W, 3) uint8 arrays or file paths.

        Returns ((S, 3, H', W') normalized batch, list of adjusted K or None).
        """

        def load(item):
            if isinstance(item, str):
                import cv2

                return cv2.cvtColor(cv2.imread(item), cv2.COLOR_BGR2RGB)
            return np.asarray(item)

        Ks = intrinsics if intrinsics is not None else [None] * len(images)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            results = list(
                pool.map(
                    lambda args: process_one(
                        load(args[0]), target_size, process_res_method, args[1]
                    ),
                    zip(images, Ks),
                )
            )
        imgs = [r[0] for r in results]
        out_Ks = [r[1] for r in results]
        # unify shapes (pad-free: crop all to the min common size)
        hs = min(i.shape[1] for i in imgs)
        ws = min(i.shape[2] for i in imgs)
        hs, ws = (hs // PATCH) * PATCH, (ws // PATCH) * PATCH
        imgs = [i[:, :hs, :ws] for i in imgs]
        return np.stack(imgs), out_Ks


InputAdapter = InputProcessor  # reference alias
