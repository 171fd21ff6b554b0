"""Image INR dataset: pixel coordinate grids and sampling modes.

Port of ``shacira_tpu/datasets/image.py`` (host-side numpy, names kept): a
directory of images trained one INR per image.  Pixel (row r, col c) maps
to ``((r/H - .5)*2, (c/W - .5)*2)``.

Sample modes:
  * 'full'       -- every pixel, one batch per epoch (static coordinates)
  * 'woreplace'  -- a random permutation without replacement, batched
  * 'sequential' -- raster order, batched
  * 'wreplace'   -- random indices with replacement (large images)
  * 'eval'       -- sequential index batches (coordinates computed per batch)

PIL is imported only when an image file is loaded.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

_SUPPORTED_FORMATS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.pgm',
                      '.tif', '.tiff', '.webp', '.JPG', '.JPEG')


def load_rgb(path: str) -> np.ndarray:
    """An image file -> [H, W, 3] float32 in [0, 1]."""
    from PIL import Image
    img = Image.open(path).convert('RGB')
    return np.asarray(img, np.float32) / 255.0


def pixel_coords(h: int, w: int) -> np.ndarray:
    """[H*W, 2] normalized coordinates in row-major pixel order."""
    r = (np.arange(h, dtype=np.float32) / h - 0.5) * 2.0
    c = (np.arange(w, dtype=np.float32) / w - 0.5) * 2.0
    gy, gx = np.meshgrid(r, c, indexing='ij')
    return np.stack([gy.reshape(-1), gx.reshape(-1)], axis=-1)


def index_to_coords(idx: np.ndarray, h: int, w: int) -> np.ndarray:
    """Flat pixel indices -> normalized coordinates."""
    rr = idx // w
    cc = idx % w
    return np.stack([(rr / h - 0.5) * 2.0, (cc / w - 0.5) * 2.0],
                    axis=-1).astype(np.float32)


class ImageDataset:
    """Coordinate / rgb sampler of one image (host side, numpy)."""

    def __init__(self, image: np.ndarray, num_samples: int = -1,
                 sample_mode: str = 'full', seed: int = 0):
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f'[H, W, 3] image expected, got {image.shape}')
        self.image = np.asarray(image, np.float32)
        self.h, self.w = image.shape[:2]
        self.num_pixels = self.h * self.w
        self.rgb = self.image.reshape(-1, 3)
        self.sample_mode = sample_mode
        if sample_mode == 'full':
            num_samples = -1
        self.num_samples = num_samples
        self.rng = np.random.RandomState(seed)
        self.static_coords = (num_samples == -1
                              or num_samples >= self.num_pixels)

        self.shuffle_idx: Optional[np.ndarray] = None
        if (sample_mode in ('full', 'woreplace', 'sequential')
                or self.static_coords):
            self.coords = pixel_coords(self.h, self.w)
            if sample_mode != 'sequential':
                self.shuffle_idx = self.rng.permutation(self.num_pixels)
                self.coords = self.coords[self.shuffle_idx]
                self.rgb_shuffled = self.rgb[self.shuffle_idx]
            else:
                self.shuffle_idx = np.arange(self.num_pixels)
                self.rgb_shuffled = self.rgb
        else:
            self.coords = None
            self.rgb_shuffled = None

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.h, self.w)

    def resample(self):
        """A new permutation for 'woreplace'."""
        if self.sample_mode == 'woreplace':
            self.shuffle_idx = self.rng.permutation(self.num_pixels)
            full = pixel_coords(self.h, self.w)
            self.coords = full[self.shuffle_idx]
            self.rgb_shuffled = self.rgb[self.shuffle_idx]

    def __len__(self) -> int:
        if self.static_coords:
            return 1
        return -(-self.num_pixels // self.num_samples)

    def batch(self, i: int):
        """(coords [n, 2], rgb [n, 3]) of batch ``i``."""
        if self.static_coords:
            return self.coords, self.rgb_shuffled
        if self.sample_mode in ('woreplace', 'sequential'):
            s = i * self.num_samples
            e = min(s + self.num_samples, self.num_pixels)
            return self.coords[s:e], self.rgb_shuffled[s:e]
        if self.sample_mode == 'eval':
            s = i * self.num_samples
            e = min(s + self.num_samples, self.num_pixels)
            idx = np.arange(s, e)
        elif self.sample_mode == 'wreplace':
            idx = self.rng.randint(0, self.num_pixels, size=self.num_samples)
        else:
            raise ValueError(self.sample_mode)
        return index_to_coords(idx, self.h, self.w), self.rgb[idx]


class MultiImageDataset:
    """A directory of images, one INR per image, in sorted file order."""

    def __init__(self, dataset_path: str, num_samples: int = -1,
                 sample_mode: str = 'full', seed: int = 0):
        self.dataset_path = dataset_path
        self.image_list: List[str] = [
            os.path.join(dataset_path, f)
            for f in sorted(os.listdir(dataset_path))
            if f.endswith(_SUPPORTED_FORMATS)]
        self.num_images = len(self.image_list)
        self.num_samples = num_samples
        self.sample_mode = sample_mode
        self.seed = seed
        self.image_idx = 0

    def load_next(self) -> ImageDataset:
        path = self.image_list[self.image_idx]
        self.image_idx += 1
        ds = ImageDataset(load_rgb(path), self.num_samples, self.sample_mode,
                          self.seed)
        ds.image_path = path
        return ds
