"""Torch networks of the port: layers, archs, moe, convert, genotype."""
