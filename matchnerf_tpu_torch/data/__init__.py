"""Host-side data helpers and datasets of the port (numpy only)."""
from .blender import BlenderDataset
from .colmap import COLMAPDataset
from .dtu import DTUDataset
from .llff import IBRNetDataset, LLFFDataset
from .tnt import TNTDataset

# dataset_name of a data_* config block -> dataset class (the JAX package's
# `datas_dict`)
DATASETS = {"blender": BlenderDataset, "colmap": COLMAPDataset, "dtu": DTUDataset,
            "ibrnet": IBRNetDataset, "llff": LLFFDataset, "tnt": TNTDataset}
