"""Unit conversions (port of ``smcdet_tpu/utils``)."""
