"""Serving runtime: paged block pool, radix prefix cache, ChunkedServer."""
