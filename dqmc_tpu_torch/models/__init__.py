from dqmc_tpu_torch.models.attractive_hubbard import AttractiveHubbard
from dqmc_tpu_torch.models.repulsive_hubbard import RepulsiveHubbard

# model registry for run.py ([hubbard] model = <name>)
MODEL_REGISTRY = {
    "attractive": AttractiveHubbard,
    "repulsive": RepulsiveHubbard,
}

__all__ = ["AttractiveHubbard", "RepulsiveHubbard", "MODEL_REGISTRY"]
