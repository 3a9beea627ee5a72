"""Device ops of the port: extension DP, candidate generation, rescore."""
