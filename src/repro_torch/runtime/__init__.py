"""Serving runtime and host-side fault tolerance of the port."""
