"""Audio front ends of prompt extraction: resampling, the 24 kHz log-mel,
kaldi fbank (CAM++) and the whisper log-mel (S3 tokenizer)."""
