from repro_torch.data.synthetic import (GaussianMixtureImages, MarkovLM,
                                        MarkovStream, MixtureImagesContinuous,
                                        arithmetic_stream)
from repro_torch.data.pipeline import HostDataLoader, repeat_batches
from repro_torch.data.tokenizer import ByteTokenizer, Text8Tokenizer
