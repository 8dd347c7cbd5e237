"""The source-extractor baseline (port of ``smcdet_tpu/detect``)."""

from smcdet_tpu_torch.detect.extractor import (  # noqa: F401
    estimate_background,
    extract,
    extract_batch,
    tune_extractor,
)
