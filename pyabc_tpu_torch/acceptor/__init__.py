"""Acceptors (port of ``pyabc_tpu/acceptor``: uniform and stochastic,
with the pdf normalizations)."""

from .acceptor import (Acceptor, AcceptorResult, SimpleFunctionAcceptor,
                       StochasticAcceptor, UniformAcceptor,
                       stochastic_accept)
from .pdf_norm import ScaledPDFNorm, pdf_norm_from_kernel, pdf_norm_max_found

__all__ = ["Acceptor", "AcceptorResult", "SimpleFunctionAcceptor",
           "UniformAcceptor", "StochasticAcceptor",
           "stochastic_accept", "pdf_norm_from_kernel", "pdf_norm_max_found",
           "ScaledPDFNorm"]
