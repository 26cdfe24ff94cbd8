"""Training step builders: the loss, value and grad by autograd, gradient
clipping and the optimizer (port of ``repro/train``)."""
