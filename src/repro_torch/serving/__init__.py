"""Continuous-batching engine, KV block manager, scheduler, requests."""
