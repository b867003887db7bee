"""Kimi-VL-A3B-Instruct: MoonViT, the MLA + MoE language model, greedy generation (model.py), its plain reference (reference.py) and a stand-in tokenizer."""
