"""Input pipeline over the distributed raw-array cache."""
