from mvlpt_torch.tokenizer.bpe import (
    ClipBpeTokenizer,
    find_bpe_vocab,
    get_tokenizer,
    tokenize,
    write_synthetic_vocab,
)
