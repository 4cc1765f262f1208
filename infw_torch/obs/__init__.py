"""Observability: frame parse, deny events, node statistics."""
