"""GPT-as-judge scoring for open-ended QA.

Counterpart of reference llava/eval/eval_videoqa.py:92-290 and its dimension
variants (correctness/context/temporal/consistency/detailed_orientation):
yes/no + 0-5 score per QA pair via an OpenAI-compatible chat API, a
multiprocessing pool, a retry-until-all-scored loop, and final
accuracy/average-score aggregation. Azure content-filter failures score 0
(reference eval_videoqa.py:77-81).

The judge prompts are data (they define the published metric) and are kept
byte-compatible per dimension. A copy of ``videollamb_tpu/eval/gpt_judge.py``
(host-only; the judge's worker processes are spawned, not forked).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import multiprocessing
from typing import Dict, List, Tuple

JUDGE_PROMPTS: Dict[str, Tuple[str, str]] = {
    # dimension -> (system prompt, user template). {question}/{answer}/{pred}
    "default": (
        "You are an intelligent chatbot designed for evaluating the correctness of generative outputs for question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they match meaningfully. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the meaningful match between the predicted answer and the correct answer.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the correctness of the prediction compared to the answer.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question: {question}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a yes/no and score where the score is an integer value between 0 and 5, with 5 indicating the highest meaningful match. "
        "Please generate the response in the form of a Python dictionary string with keys 'pred' and 'score', where value of 'pred' is  a string of 'yes' or 'no' and value of 'score' is in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'pred': 'yes', 'score': 4.8}}.",
    ),
    "correctness": (
        "You are an intelligent chatbot designed for evaluating the factual accuracy of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they are factually consistent. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the factual consistency between the predicted answer and the correct answer. The predicted answer should not contain any misinterpretations or misinformation.\n"
        "- The predicted answer must be factually accurate and align with the video content.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the factual accuracy of the prediction compared to the answer.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question: {question}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a factual accuracy score where the factual accuracy score is an integer value between 0 and 5, with 5 indicating the highest level of factual consistency. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the factual accuracy score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'score': 4.8}}.",
    ),
    "detailed_orientation": (
        "You are an intelligent chatbot designed for evaluating the detail orientation of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine its level of detail, considering both completeness and specificity. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Check if the predicted answer covers all major points from the video. The response should not leave out any key aspects.\n"
        "- Evaluate whether the predicted answer includes specific details rather than just generic points. It should provide comprehensive information that is tied to specific elements of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide a single evaluation score that reflects the level of detail orientation of the prediction, considering both completeness and specificity.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question: {question}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a detail orientation score where the detail orientation score is an integer value between 0 and 5, with 5 indicating the highest level of detail orientation. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the detail orientation score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'score': 4.8}}.",
    ),
    "context": (
        "You are an intelligent chatbot designed for evaluating the contextual understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if the generated response aligns with the overall context of the video content. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Evaluate whether the predicted answer aligns with the overall context of the video content. It should not provide information that is out of context or misaligned.\n"
        "- The predicted answer must capture the main themes and sentiments of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide your evaluation of the contextual understanding of the prediction compared to the answer.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question: {question}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a contextual understanding score where the contextual understanding score is an integer value between 0 and 5, with 5 indicating the highest level of contextual understanding. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the contextual understanding score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'score': 4.8}}.",
    ),
    "temporal": (
        "You are an intelligent chatbot designed for evaluating the temporal understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they correctly reflect the temporal sequence of events in the video content. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the temporal consistency between the predicted answer and the correct answer. The predicted answer should correctly reflect the sequence of events or details as they are presented in the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only if the temporal order is maintained.\n"
        "- Evaluate the temporal accuracy of the prediction compared to the answer.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question: {question}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a temporal accuracy score where the temporal accuracy score is an integer value between 0 and 5, with 5 indicating the highest level of temporal consistency. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the temporal accuracy score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'score': 4.8}}.",
    ),
    "consistency": (
        "You are an intelligent chatbot designed for evaluating the consistency of generative outputs for similar video-based question-answer pairs. "
        "You will be given two very similar questions, a common answer common to both the questions and predicted answers for the two questions ."
        "Your task is to compare the predicted answers for two very similar question, with a common correct answer and determine if they are consistent. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the consistency between the two predicted answers and the correct answer. Both predicted answers should correspond to the correct answer and to each other, and should not contain any contradictions or significant differences in the conveyed information.\n"
        "- Both predicted answers must be consistent with each other and the correct answer, in terms of the information they provide about the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only if they maintain the consistency in the conveyed information.\n"
        "- Evaluate the consistency of the two predicted answers compared to the correct answer.",
        "Please evaluate the following video-based question-answer pair:\n\n"
        "Question 1: {question}\n"
        "Question 2: {question2}\n"
        "Correct Answer: {answer}\n"
        "Predicted Answer to Question 1: {pred}\n"
        "Predicted Answer to Question 2: {pred2}\n\n"
        "Provide your evaluation only as a consistency score where the consistency score is an integer value between 0 and 5, with 5 indicating the highest level of consistency. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the consistency score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {{'score': 4.8}}.",
    ),
}


def judge_messages(dimension: str, qa: Dict) -> List[Dict[str, str]]:
    system, user = JUDGE_PROMPTS[dimension]
    return [
        {"role": "system", "content": system},
        {"role": "user", "content": user.format(
            question=qa["q"], answer=qa["a"], pred=qa["pred"],
            question2=qa.get("q2", ""), pred2=qa.get("pred2", ""),
        )},
    ]


def call_api(messages, api_key: str, api_base: str, model: str) -> str:
    """OpenAI-compatible chat completion (reference openai_api_1)."""
    import urllib.request

    req = urllib.request.Request(
        f"{api_base.rstrip('/')}/chat/completions",
        data=json.dumps({"model": model, "messages": messages}).encode(),
        headers={"Content-Type": "application/json",
                 "Authorization": f"Bearer {api_key}"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        data = json.load(resp)
    return data["choices"][0]["message"]["content"]


def annotate(job) -> None:
    """Score one batch of QA pairs; content-filter errors score 0
    (reference eval_videoqa.py:77-81)."""
    prediction_set, keys, output_dir, args = job
    for key in keys:
        qa = prediction_set[key]
        try:
            msg = judge_messages(args.dimension, qa)
            response = call_api(msg, args.api_key, args.api_base, args.model)
            response_dict = ast.literal_eval(response)
            with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                json.dump([response_dict, qa], f)
        except Exception as e:
            if "content_filter" in str(e) or "ResponsibleAIPolicyViolation" in str(e):
                with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                    json.dump([{"pred": "no", "score": 0}, qa], f)
            else:
                print(f"Error processing '{key}': {e}")


def load_predictions(pred_path: str) -> Dict[str, Dict]:
    prediction_set = {}
    with open(pred_path) as f:
        for line in f:
            rec = json.loads(line)
            key = str(rec.get("id"))
            prediction_set[key] = {"q": rec["question"], "a": rec["answer"],
                                   "pred": rec["pred"]}
    return prediction_set


def aggregate(output_dir: str) -> Dict[str, float]:
    """Final accuracy (yes-ratio) + average score (reference
    eval_videoqa.py:239-286)."""
    yes, no, total_score, n = 0, 0, 0.0, 0
    for name in os.listdir(output_dir):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(output_dir, name)) as f:
            result, _ = json.load(f)
        n += 1
        total_score += float(result.get("score", 0))
        pred = str(result.get("pred", "no")).lower()
        if "yes" in pred:
            yes += 1
        else:
            no += 1
    return {
        "accuracy": yes / max(yes + no, 1),
        "average_score": total_score / max(n, 1),
        "n": n,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_json", required=True)
    parser.add_argument("--api_key", required=True)
    parser.add_argument("--api_base", default="https://api.openai.com/v1")
    parser.add_argument("--model", default="gpt-3.5-turbo-0125")
    parser.add_argument("--num_tasks", type=int, default=8)
    parser.add_argument("--dimension", default="default",
                        choices=sorted(JUDGE_PROMPTS))
    args = parser.parse_args()

    prediction_set = load_predictions(args.pred_path)
    os.makedirs(args.output_dir, exist_ok=True)

    # Retry until every file is scored (reference eval_videoqa.py:205-236).
    while True:
        done = {f[:-5] for f in os.listdir(args.output_dir) if f.endswith(".json")}
        todo = [k for k in prediction_set if k not in done]
        if not todo:
            break
        print(f"{len(todo)} remaining")
        chunks = [todo[i::args.num_tasks] for i in range(args.num_tasks)]
        jobs = [(prediction_set, c, args.output_dir, args) for c in chunks if c]
        with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
            pool.map(annotate, jobs)

    summary = aggregate(args.output_dir)
    with open(args.output_json, "w") as f:
        json.dump(summary, f)
    print(summary)


if __name__ == "__main__":
    main()
