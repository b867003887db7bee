"""Kimi-VL-A3B-Instruct: MoonViT, the MLA + MoE language model, greedy
generation (model.py) and a stand-in tokenizer. Its plain float32
reference is portbench/reference/kimi_vl.py."""
