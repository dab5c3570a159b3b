"""Launch layer: the train and serve drivers, meshes, the dry run with its
roofline and report, and the Chrome-trace export of a lifecycle trace.

Counterpart of ``repro.launch``. ``Trainer``, ``TrainerConfig`` and
``make_train_step`` are ``repro_torch.launch.train``'s, loaded on first
use (so that ``python -m repro_torch.launch.train`` runs that module
once).
"""

__all__ = ["Trainer", "TrainerConfig", "make_train_step"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.launch import train
        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
