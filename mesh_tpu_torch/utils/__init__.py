"""Device choice and environment knobs for the PyTorch port."""
