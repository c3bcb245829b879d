"""Serving runtime: sampling, the paged continuous-batching engine, weights."""
