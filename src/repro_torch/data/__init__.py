from repro_torch.data.pipeline import SyntheticLMDataset, make_batch_iterator
from repro_torch.data.partition import dirichlet_partition, iid_partition

__all__ = [
    "SyntheticLMDataset",
    "make_batch_iterator",
    "iid_partition",
    "dirichlet_partition",
]
