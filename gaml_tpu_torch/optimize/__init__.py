from .settings import AssemblySettings
from .anneal import Optimizer
