"""Dual-pathway retrieval: feature search, token budgets, QA."""
