"""Tacotron 2 and HiFi-GAN as torch modules with the reference's parameter names."""
