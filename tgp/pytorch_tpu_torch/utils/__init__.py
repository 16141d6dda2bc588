from .logging import MetricLogger
from .profiling import trace, step_timer
