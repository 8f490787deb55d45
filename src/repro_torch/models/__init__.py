"""The model stack of the port: the dense GQA decoder (configuration,
parameters, attention through the hand-written kernels, forward)."""
