"""Image models, PSFs, priors and the simulator."""
