"""Benchmarks of the port: the QA-accuracy harness (qa_harness) and its
command line (qa_accuracy)."""
