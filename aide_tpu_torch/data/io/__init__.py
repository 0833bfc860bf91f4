"""aide_tpu_torch.data.io: the DICOM, NIfTI, NRRD and PNG readers and writers."""

from aide_tpu_torch.data.io.dicom import DicomFile, read_dicom  # noqa: F401
from aide_tpu_torch.data.io.nifti import read_nifti, write_nifti  # noqa: F401
from aide_tpu_torch.data.io.nrrd import read_nrrd, write_nrrd  # noqa: F401
from aide_tpu_torch.data.io.png import read_image_rgb, read_mask, write_mask  # noqa: F401
