"""Data layer of the port: dataset loaders and registry (name-keyed
``collections``, as in ``event_based_optical_flow_tpu/data``).  MVSEC and
DSEC read HDF5 through ``h5py``, imported when a sequence is set."""

import os

DATASET_ROOT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "datasets"
)

from .base import DataLoaderBase, EventArrayLoader
from .dsec import DsecDataLoader
from .ecd import EcdDataLoader
from .evt2 import Evt2DataLoader
from .evt3 import Evt3DataLoader
from .mvsec import MvsecDataLoader
from .synthetic import SyntheticDataLoader

collections = {
    MvsecDataLoader.NAME: MvsecDataLoader,
    SyntheticDataLoader.NAME: SyntheticDataLoader,
    DsecDataLoader.NAME: DsecDataLoader,
    EcdDataLoader.NAME: EcdDataLoader,
    Evt2DataLoader.NAME: Evt2DataLoader,
    Evt3DataLoader.NAME: Evt3DataLoader,
}

__all__ = ["DataLoaderBase", "EventArrayLoader", "MvsecDataLoader", "SyntheticDataLoader", "DsecDataLoader",
           "EcdDataLoader", "Evt2DataLoader", "Evt3DataLoader", "collections", "DATASET_ROOT_DIR"]
