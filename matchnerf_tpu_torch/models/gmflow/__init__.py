"""GMFlow matching encoder of the port."""
