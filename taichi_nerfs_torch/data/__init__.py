"""Datasets: the base class, the procedural synthetic scenes and camera
rigs, and the file loaders (``dataset_dict``, as ``train.py`` selects them
by ``--dataset_name``)."""

from .colmap import ColmapDataset
from .nerf import NeRFDataset
from .ngp import NGPDataset
from .nsvf import NSVFDataset
from .synthetic import SyntheticSphereDataset

dataset_dict = {
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "ngp": NGPDataset,
    "synthetic": SyntheticSphereDataset,
}
