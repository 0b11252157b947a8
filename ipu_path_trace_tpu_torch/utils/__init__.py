"""Logging, named spans, tensor introspection and device phase timing."""
