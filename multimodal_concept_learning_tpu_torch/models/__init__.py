"""ViT tower, Gemma-style causal LM and the MLLM composite (torch nn.Modules)."""
