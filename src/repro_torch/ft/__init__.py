from .preemption import PreemptionHandler
from .straggler import StepTimer, StragglerMonitor

__all__ = ["StragglerMonitor", "StepTimer", "PreemptionHandler"]
