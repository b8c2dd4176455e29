"""Serving runtime, host-side fault tolerance and corpus meshes of the port."""
