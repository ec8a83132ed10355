"""Service entry points of the port."""
