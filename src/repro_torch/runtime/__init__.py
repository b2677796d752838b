"""``repro_torch.runtime`` — the fault-tolerant training driver, port of ``repro.runtime``."""
from repro_torch.runtime.driver import FailureInjector, StragglerMonitor, TrainDriver

__all__ = ['TrainDriver', 'StragglerMonitor', 'FailureInjector']
