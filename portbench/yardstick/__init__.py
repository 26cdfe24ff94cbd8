"""The benchmark's own arithmetic: traffic generation, weights from the
seed, the reduction of traces and spans to metrics, the H100's peaks and
the operation and byte counts of the kernels and the model. Nothing here
imports the program under test."""
