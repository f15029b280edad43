"""Host-side text: the CLIP and GPT-2 BPE tokenizers and the Porter
stemmer."""
