"""Data layer of the port: the HDF5 cohort loaders, the DICOM and NIfTI
readers, writers and series loaders, the MEBCRN ↔ legacy layout
converters, 2-D phase unwrapping, the training augmentations and the GAN
replay pool.
h5py is imported only when an HDF5 file is opened."""

from .augment import (bipolar_phase_row, random_echo_count, random_fm_scale,
                      random_geometric, random_phase_offset)
from .dicom import (DicomDataset, gen_ds, load_dicom_series, read_dicom,
                    write_dicom)
from .hdf5 import (Hdf5Data, acqs_mebcrn, complex_maps_mebcrn, group_tes,
                   iterate_hdf5, load_hdf5, mag_phase_maps)
from .layouts import (acqs_from_mebcrn, acqs_to_mebcrn,
                      mag_phase_to_complex_mebcrn, maps_from_mebcrn,
                      maps_to_mebcrn)
from .nifti import load_nifti_series, read_nifti, write_nifti
from .pool import ItemPool
from .unwrap import unwrap_phase_2d, unwrap_slices

__all__ = [
    "Hdf5Data", "load_hdf5", "group_tes", "iterate_hdf5", "mag_phase_maps",
    "complex_maps_mebcrn", "acqs_mebcrn", "acqs_from_mebcrn",
    "acqs_to_mebcrn", "maps_from_mebcrn", "maps_to_mebcrn",
    "mag_phase_to_complex_mebcrn", "unwrap_phase_2d", "unwrap_slices",
    "bipolar_phase_row", "random_echo_count", "random_fm_scale",
    "random_geometric", "random_phase_offset", "ItemPool",
    "DicomDataset", "gen_ds", "write_dicom", "read_dicom",
    "load_dicom_series", "read_nifti", "write_nifti", "load_nifti_series",
]
