"""Survey data ingestion (port of ``smcdet_tpu/ingest``): a pure-numpy
FITS reader/writer, TAN-projection WCS math, bicubic band alignment and
direct PSF-profile evaluation. Byte I/O and catalogs stay numpy on the
host; pixel grids (the alignment, the calibration, PSF stamps) are tensors
on an explicit device. Nothing here opens a network connection: a missing
survey file raises ``FileNotFoundError`` naming it and its archive URL.
"""

from smcdet_tpu_torch.ingest import fits  # noqa: F401
from smcdet_tpu_torch.ingest.align import align  # noqa: F401
from smcdet_tpu_torch.ingest.catalogs import (  # noqa: F401
    FullCatalog,
    SourceType,
    TileCatalog,
)
from smcdet_tpu_torch.ingest.psf import (  # noqa: F401
    ImagePSF,
    PSFConfig,
    render_psf_image,
)
from smcdet_tpu_torch.ingest.sdss import (  # noqa: F401
    PhotoFullCatalog,
    SDSSDownloader,
    SloanDigitalSkySurvey,
    read_frame,
    read_psf_params,
)
from smcdet_tpu_torch.ingest.survey import (  # noqa: F401
    Survey,
    SurveyPredictIterator,
)
from smcdet_tpu_torch.ingest.wcs import TanWCS  # noqa: F401
