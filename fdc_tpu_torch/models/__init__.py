"""Channelization modes as ``nn.Module``s over batched FFT blocks."""
