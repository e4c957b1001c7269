from repro_torch.data.synthetic import MarkovLM, MixtureImagesContinuous
