"""``repro_torch.runtime`` — the fault-tolerant training driver, port of ``repro.runtime``."""
from repro_torch.runtime.driver import (FailureInjector, InjectedFailure, StragglerMonitor,
                                       TrainDriver)

__all__ = ['TrainDriver', 'StragglerMonitor', 'FailureInjector', 'InjectedFailure']
