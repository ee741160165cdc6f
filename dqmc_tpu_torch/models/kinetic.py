"""Kinetic-propagator application, dense expK.

PyTorch counterpart of the dense branch of ``dqmc_tpu/models/kinetic.py``:
the engine never needs exp(-dtau K) alone, only the four products with
B = diag(expV) expK.  ``X`` carries any leading batch axes and ``fields_l``
the matching leading axes without the flavor axis.

Checkerboard kinetics are not ported yet (ROADMAP "Modules to port", slice
3: other models and geometries).
"""

from __future__ import annotations


def _dense(model):
    if getattr(model, "checkerboard", False):
        raise NotImplementedError(
            "checkerboard kinetics are not ported to dqmc_tpu_torch yet "
            "(ROADMAP: modules to port, slice 3 'other models and "
            "geometries')")


def apply_B_left(model, fields_l, X):
    """B @ X"""
    _dense(model)
    expV = model.expV_diag(fields_l)
    return expV[..., :, None] * (model.expK @ X)


def apply_B_right(model, fields_l, X):
    """X @ B"""
    _dense(model)
    expV = model.expV_diag(fields_l)
    return (X * expV[..., None, :]) @ model.expK


def apply_invB_left(model, fields_l, X):
    """B^{-1} @ X = expK^{-1} (diag(expV)^{-1} X)"""
    _dense(model)
    expV = model.expV_diag(fields_l)
    return model.invexpK @ (X / expV[..., :, None])


def apply_invB_right(model, fields_l, X):
    """X @ B^{-1} = (X expK^{-1}) diag(expV)^{-1}"""
    _dense(model)
    expV = model.expV_diag(fields_l)
    return (X @ model.invexpK) / expV[..., None, :]
