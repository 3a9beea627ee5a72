from .rng import GamlRng
