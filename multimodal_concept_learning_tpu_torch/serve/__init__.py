"""Paged continuous-batching serving front (HTTP server, batcher, engine, loader)."""
