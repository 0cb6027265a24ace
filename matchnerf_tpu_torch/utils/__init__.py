"""Host-side utilities of the port (no torch, no jax)."""
