from newsrecommendation_tpu_torch.data.mind import (  # noqa: F401
    NewsCorpus,
    build_news_features,
    random_word_embeddings,
    read_news,
    tokenize,
)
from newsrecommendation_tpu_torch.data.prepare import (  # noqa: F401
    prepare_testing_data,
    prepare_training_data,
)
from newsrecommendation_tpu_torch.data.loader import (  # noqa: F401
    EvalSamples,
    TrainSamples,
)
