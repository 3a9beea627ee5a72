from .likelihood import (LikelihoodModel, PairedEndModel, SingleEndModel,
                         from_params)
