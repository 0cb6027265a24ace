"""Host-side data helpers and datasets of the port (numpy only)."""
from .colmap import COLMAPDataset
from .dtu import DTUDataset

# dataset_name of a data_* config block -> dataset class (the JAX package's
# `datas_dict`); LLFF, Blender, T&T and IBRNet are not ported yet
DATASETS = {"colmap": COLMAPDataset, "dtu": DTUDataset}
