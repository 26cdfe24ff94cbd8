"""The plain reference that decides ``correct``: plain torch and numpy
only, importing neither JAX, nor the JAX package, nor the program."""
