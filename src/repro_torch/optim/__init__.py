"""Training-side pieces of the port.  So far only the binary
activation's straight-through estimator that the CIFAR networks'
``train=True`` forward uses; the optimizer and QAT scopes come with the
training slice."""
from .qat import ste_sign

__all__ = ["ste_sign"]
