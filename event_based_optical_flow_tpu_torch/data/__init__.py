"""Data layer of the port: dataset loaders and registry (name-keyed
``collections``, as in ``event_based_optical_flow_tpu/data``).

Only the synthetic loader is ported so far; the MVSEC, DSEC, ECD and
EVT2/EVT3 loaders are still to be ported."""

import os

DATASET_ROOT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "datasets"
)

from .base import DataLoaderBase
from .synthetic import SyntheticDataLoader

collections = {
    SyntheticDataLoader.NAME: SyntheticDataLoader,
}

__all__ = ["DataLoaderBase", "SyntheticDataLoader", "collections", "DATASET_ROOT_DIR"]
