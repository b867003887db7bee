"""The benchmark's own tests (CPU, tiny sizes; card tests carry the cuda marker)."""
