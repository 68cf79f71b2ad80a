"""Pool language models: layers, attention with a linear KV cache, the LM."""
