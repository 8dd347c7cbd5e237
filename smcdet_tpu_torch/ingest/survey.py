"""Survey abstraction + prediction iterator (port of
``smcdet_tpu/ingest/survey.py``).

``Survey`` is the contract (``prepare_data`` / ``__getitem__`` /
``image_ids``); ``SurveyPredictIterator`` does the pixel work on an
explicit device: background subtraction, flux calibration, optional band
alignment, band/hw cropping, and the crop to a multiple of 16.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from smcdet_tpu_torch.ingest.align import align

__all__ = ["Survey", "SurveyPredictIterator"]


class Survey(ABC):
    BANDS = ()

    align_to_band = None
    crop_to_hw = None
    crop_to_bands = None

    @abstractmethod
    def prepare_data(self):
        """Stage everything __getitem__ needs."""

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, idx):
        ...

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @abstractmethod
    def image_id(self, idx: int):
        ...

    @abstractmethod
    def idx(self, image_id):
        ...

    @abstractmethod
    def image_ids(self) -> list:
        ...

    def predict_dataloader(self, device="cuda"):
        return SurveyPredictIterator(self, device)


class SurveyPredictIterator:
    """Yields calibrated, aligned, cropped images ready for inference, as
    float32 tensors on ``device`` (the arithmetic in float64)."""

    def __init__(self, survey, device="cuda"):
        self.survey = survey
        self.device = torch.device(device)

    @classmethod
    def crop_to_mult16(cls, x):
        height = x.shape[1] - (x.shape[1] % 16)
        width = x.shape[2] - (x.shape[2] % 16)
        return x[:, :height, :width]

    def __getitem__(self, idx):
        item = self.survey[idx]

        def f64(v):
            return torch.as_tensor(v, dtype=torch.float64, device=self.device)

        images = f64(item["image"])
        images = images - f64(item.get("background", 0.0))
        images = images / f64(item["flux_calibration"])[:, None, :]

        if getattr(self.survey, "align_to_band", None) is not None:
            images = align(
                images,
                wcs_list=item["wcs"],
                ref_band=self.survey.align_to_band,
                device=self.device,
            )

        psf_params = item["psf_params"]
        if getattr(self.survey, "crop_to_bands", None) is not None:
            images = images[self.survey.crop_to_bands]
            psf_params = psf_params[self.survey.crop_to_bands]

        if getattr(self.survey, "crop_to_hw", None) is not None:
            r1, r2, c1, c2 = self.survey.crop_to_hw
            images = images[:, r1:r2, c1:c2]

        images = self.crop_to_mult16(images.to(torch.float32))
        return {"images": images, "psf_params": psf_params}

    def __len__(self):
        return len(self.survey)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
