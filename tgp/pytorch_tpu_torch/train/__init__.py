from .optimizers import make_optimizer, build_grouped_optimizer
from .trainer import Trainer
from . import metrics
from . import multiseed
