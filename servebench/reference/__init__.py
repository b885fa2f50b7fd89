"""The plain reference: a decoder-only transformer in f32 PyTorch, with
no kernel, cache or batching of the program's."""
