"""Models: encoder, cross-encoder and the Llama-3 decoder, in PyTorch."""
