"""SGE cluster batch mapper (the port's copy of ``pyabc_tpu/sge``): a
``map`` over ``qsub`` array jobs with file-pickle transport, with a
local subprocess pool where no ``qsub`` exists.  It maps host functions;
each task runs in a process of its own (``python -m
pyabc_tpu_torch.sge.execute_load``), which imports the package but
touches no card."""

from .execution_contexts import DefaultContext, NamedPrinter, ProfilingContext
from .sge import SGE
from .util import sge_available

__all__ = ["SGE", "sge_available", "DefaultContext", "ProfilingContext",
           "NamedPrinter"]
