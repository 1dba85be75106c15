"""Training tutorials (port of the JAX package's ``examples/train``): the loop that the task entry points
automate, written out inline in torch."""
