"""Device ops of the port: plain tensor code around the hand-written
Hopper kernels of ``kernels/``."""
