"""Training input pipeline on the Zerrow core."""
