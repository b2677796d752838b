"""Mesh construction for the port."""
