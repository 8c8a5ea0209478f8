"""Numerical ops: the BN+activation kernel, losses, image decode."""
