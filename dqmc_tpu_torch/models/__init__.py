from dqmc_tpu_torch.models.attractive_hubbard import AttractiveHubbard

__all__ = ["AttractiveHubbard"]
