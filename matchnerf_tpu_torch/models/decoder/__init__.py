"""CondNeRF decoder of the port."""
