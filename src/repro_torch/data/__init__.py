from repro_torch.data.synthetic import (GaussianMixtureImages, MarkovLM,
                                        MixtureImagesContinuous)
